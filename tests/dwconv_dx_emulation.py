"""Numpy emulation of the bf16 backward's second tile, ``dwconv_dx_tc_kernel``
with its stencil (csrc/dwconv_dx.cuh), from its own tile map; on a row
shard, of grad.cu's ``dwconv_halo_bwd_kernel`` (the halo rows' cotangents and
tap partials, which the tile leaves out) and of the wrapper's halo-row
backward (``spectral._halo_rows_bwd``); and the tile helpers the emulations
of the first tiles share: the spectral stats backward
(K = 2C, tests/test_torch_stats_bwd.py), the spectral apply backward (K =
C, with the extra input cotangent in the epilogue, tests/test_torch_apply_bwd.py)
and the GDFN backward (K = 2 hid, t in float32, the residual's dy as the
extra, tests/test_torch_gdfn_bwd.py). Imports no JAX."""

import numpy as np
import torch

from mp_hsir_tpu_torch.ops.kernels.spectral import dwconv_dx_plan


def rnd(a, dt):
    """``a`` rounded to ``dt`` and back to float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dt).float().numpy()


def ln(a, w, b, eps):
    """(xhat, rstd, LN(a) or None) over the last axis."""
    mu = a.mean(-1, keepdims=True)
    rs = 1 / np.sqrt(((a - mu) ** 2).mean(-1, keepdims=True) + eps)
    return (a - mu) * rs, rs, None if w is None else (a - mu) * rs * w + b


def tiles(a, top=None, bot=None):
    """(B, H, W, n) -> (B, H/8, W/8, 10 x 10 halo, n), zero outside the image;
    a row shard's halo rows ``top`` / ``bot`` (B, W, n) stand in the padding
    rows above / below it (None: zero, an image edge)."""
    b, h, w, n = a.shape
    p = np.pad(a, ((0, 0), (1, 1), (1, 1), (0, 0)))
    if top is not None:
        p[:, 0, 1:-1] = top
    if bot is not None:
        p[:, -1, 1:-1] = bot
    out = np.zeros((b, h // 8, w // 8, 100, n), np.float32)
    for ty in range(h // 8):
        for tx in range(w // 8):
            out[:, ty, tx] = p[:, 8 * ty:8 * ty + 10, 8 * tx:8 * tx + 10].reshape(b, 100, n)
    return out


def interior(halo):
    """(..., 100, n) halo -> (..., 64, n) tile pixels."""
    return halo.reshape(*halo.shape[:-2], 10, 10, halo.shape[-1])[..., 1:9, 1:9, :].reshape(
        *halo.shape[:-2], 64, halo.shape[-1])


def tile_rows(a):
    """(B, H, W, n) -> (B, H/8, W/8, 64, n): each tile's pixels in row order."""
    b, h, w, n = a.shape
    return a.reshape(b, h // 8, 8, w // 8, 8, n).transpose(0, 1, 3, 2, 4, 5).reshape(
        b, h // 8, w // 8, 64, n)


def untile(t, b, h, w):
    """(tiles, 64, n) in tile order -> (B, H, W, n)."""
    n = t.shape[-1]
    return t.reshape(b, h // 8, w // 8, 8, 8, n).transpose(0, 1, 3, 2, 4, 5).reshape(b, h, w, n)


def launch2(x, dout, t, taps, wk, lnw, shift, dt, eps, extra=None):
    """The second tile on every 8x8 tile (K = dout's channels, in 64-channel
    chunks): (dt, dx in x's frame, the per-tile partial rows: the taps [9][K],
    then with LN d ln_w and d ln_b). dout (float32) and t are in the kernel
    frame, x in its own (read at the roll-back); taps [K][9], wk [K][>= C]
    the 1x1's rows; ``extra`` (kernel frame, float32) is added to dx before it
    rounds, after the LayerNorm backward."""
    b, h, w, c = x.shape
    k = dout.shape[-1]
    pl = dwconv_dx_plan(c, k)
    dq, tt = tiles(dout), tiles(t)
    nt = dq.shape[1] * dq.shape[2]
    dtt = np.zeros(dq.shape[:3] + (64, k), np.float32)
    tp = np.zeros(dq.shape[:3] + (9, k), np.float32)
    dxn = np.zeros(dq.shape[:3] + (64, c), np.float32)
    for ch in range(pl["nck"]):
        ks = np.arange(64 * ch, min(64 * ch + 64, k))
        d10 = dq[..., ks].reshape(*dq.shape[:3], 10, 10, len(ks))
        t10 = tt[..., ks].reshape(*dq.shape[:3], 10, 10, len(ks))
        # the transposed stencil: products rounded, added in tap order
        s = np.zeros(dq.shape[:3] + (8, 8, len(ks)), np.float32)
        for ty in range(3):
            for tx in range(3):
                s = s + (d10[..., ty:ty + 8, tx:tx + 8, :] * taps[ks, 8 - 3 * ty - tx]).astype(
                    np.float32)
        chunk = rnd(s.reshape(*s.shape[:3], 64, len(ks)), dt)
        dtt[..., ks] = chunk
        own = d10[..., 1:9, 1:9, :]
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            tp[..., tap, ks] = (t10[..., dy:dy + 8, dx:dx + 8, :] * own).sum((-3, -2))
        dxn += chunk @ wk[ks, :c]
    xt = tile_rows(np.roll(x, (shift, shift), axis=(1, 2)))  # x read at the roll-back
    parts = [tp.reshape(b, h // 8, w // 8, 9 * k)]
    if lnw is not None:
        xh, rs, _ = ln(xt, None, None, eps)
        g = dxn * lnw
        dx = (g - g.mean(-1, keepdims=True) - xh * (g * xh).mean(-1, keepdims=True)) * rs
        parts += [(dxn * xh).sum(-2), dxn.sum(-2)]
    else:
        dx = dxn
    if extra is not None:
        dx = dx + tile_rows(extra)
    dx = np.roll(untile(rnd(dx, dt).reshape(-1, 64, c), b, h, w), (-shift, -shift), axis=(1, 2))
    assert nt == (h // 8) * (w // 8)
    return (untile(dtt.reshape(-1, 64, k), b, h, w), dx,
            np.concatenate(parts, -1).reshape(b * nt, -1))


def halo_row_out(t, side, b, h, w):
    """The halo row ``side`` (0: above the shard, read by the first tile row;
    1: below, the last) of a tile-map array (B, H/8, W/8, 100, n), as a first
    tile's halo_row_out writes it: (B, W, n)."""
    ty = 0 if side == 0 else h // 8 - 1
    r = 0 if side == 0 else 9
    rows = t[:, ty].reshape(b, w // 8, 10, 10, t.shape[-1])[:, :, r, 1:9]
    return rows.reshape(b, w, t.shape[-1])


def halo_taps(dout, t_halo, taps, flags, dt, fault=""):
    """grad.cu's dwconv_halo_bwd_kernel from its block map, one block per (8
    columns, image, side), then the in-order sum of its part rows per side:
    (dt_halo [2][B][W][K] rounded to dt, zero on a side without its bit;
    dw_halo [2][3][K], the taps' first row's share from the row above and
    the last row's from the row below). dout (B, H, W, K) float32, t_halo
    [2][B][W][K], taps [K][9]. fault "no_taps": the tap partials left out."""
    b, h, w, k = dout.shape
    dth = np.zeros((2, b, w, k), np.float32)
    part = np.zeros((2, b, w // 8, 3, k), np.float32)
    for side in range(2):
        if not flags & (1 << side):
            continue
        d = np.pad(dout[:, 0 if side == 0 else h - 1], ((0, 0), (1, 1), (0, 0)))  # columns
        tp = np.pad(t_halo[side], ((0, 0), (1, 1), (0, 0)))
        dy = 0 if side == 0 else 2
        acc = np.zeros((b, w, k), np.float32)
        for dx in range(3):  # products rounded, added in the flipped taps' order
            acc = acc + (d[:, dx:dx + w] * taps[:, dy * 3 + 2 - dx]).astype(np.float32)
        dth[side] = rnd(acc, dt)
        own = d[:, 1:w + 1]
        for dx in range(3):
            prod = (tp[:, dx:dx + w] * own).reshape(b, w // 8, 8, k)
            part[side, :, :, dx] = prod.sum(2)
    if fault == "no_taps":
        part[:] = 0
    dw = np.zeros((2, 3, k), np.float32)
    for side in range(2):
        for row in part[side].reshape(-1, 3, k):  # sum_parts: the blocks in order
            dw[side] += row
    return dth, dw


def halo_rows_bwd(dt_halo, wk, rows, lnw, eps, flags, un_halo, dt):
    """spectral._halo_rows_bwd: the halo rows' input cotangents from their 1x1
    output's (dt_halo [2][B][W][K]) through the 1x1 (wk [K][>= C], the rows'
    weights) and the LayerNorm backward on the raw rows ([2][B][W][C]) in
    float32, rounded to dt: (d top, d bot (None at an image edge), their 1x1
    weight gradient [K][C], (d ln_w, d ln_b) or None)."""
    c = rows.shape[-1]
    dxn = dt_halo @ wk[:, :c]
    dln = None
    if lnw is not None:
        xh, rs, _ = ln(rows, None, None, eps)
        g = dxn * lnw
        dxr = (g - g.mean(-1, keepdims=True) - xh * (g * xh).mean(-1, keepdims=True)) * rs
        dln = ((dxn * xh).sum((0, 1, 2)), dxn.sum((0, 1, 2)))
    else:
        dxr = dxn
    dxr = rnd(dxr, dt)
    dw = dt_halo.reshape(-1, dt_halo.shape[-1]).T @ un_halo.reshape(-1, c)
    return (dxr[0][:, None] if flags & 1 else None, dxr[1][:, None] if flags & 2 else None, dw,
            dln)
