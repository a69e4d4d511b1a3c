"""The bf16 MLP backward tile (``mlp_bwd_tc_kernel`` in csrc/mlp.cu, K9)
without a card: the plan mirror ``mlp_bwd_tc_plan``, and the tile emulated
in numpy from its own tile map (the weight stream of ``TailRingT<true>`` over
``pack_mlp_weights``' packs, the slab's a|g column order, the per-tile
partials) at the same rounding points, against ``mlp_bwd_plain``; one tiny
case against JAX's ``_mlp_bwd_call`` in interpret mode. The kernel itself is
held against the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py. Imports JAX only in the test that compares with it."""

import numpy as np
import pytest
import torch

from mp_hsir_tpu_torch.ops.basic import gelu_exact
from mp_hsir_tpu_torch.ops.kernels.mlp import (
    MLP_BWD_BUDGET, TAIL_K, TAIL_STAGE, mlp, mlp_bwd_plain, mlp_bwd_tc_plan, pack_mlp_weights,
)
from torch_port_inputs import rng as _rng
import torch_threads  # noqa: E402,F401  (one compute thread per process)

# (C, hid): every preset width (hid = int(2.66 C), never a multiple of 64: the
# last hidden chunk is ragged; 255 and 1021 odd: the g-half of dh starts at
# an odd column), and C = 36 and 27 (C % 8 != 0: element-wise staging; both
# pad to CK = 64)
WIDTHS = [(64, 170), (128, 340), (256, 680), (96, 255), (192, 510), (384, 1021), (36, 95),
          (27, 71)]
# the plan per width: (ring stages, dynamic bytes); 4 stages do not fit at
# C = 384 (244,224 B)
PLANS = {64: (4, 121344), 128: (4, 145920), 256: (4, 195072), 96: (4, 145920),
         192: (4, 170496), 384: (3, 225792), 36: (4, 121344), 27: (4, 121344)}
# slab column of each unit of a chunk: a-unit 16 q + i at 32 q + i, its g 16 further
A_COLS = np.array([32 * q + i for q in range(4) for i in range(16)])
G_COLS = A_COLS + 16


def _stream(pl, w1p, w2p):
    """The weight stream's tiles in order, as TailRingT<true>::issue copies
    them: per hidden chunk the slab's nk1 depth tiles ([128][64]), nk2 fc2
    tiles (channel rows n0.. of the chunk's 64 unit columns; rows past CK
    never copied, NaN here), then the slab's tiles again."""
    w1 = w1p.float().numpy()
    w2 = w2p.float().numpy()
    ck, nk1, nk2 = pl["ck"], pl["nk1"], pl["nk2"]
    tiles = []
    for t in range(pl["tiles"]):
        chunk, pos = divmod(t, pl["per"])
        if pos >= nk1 + nk2:
            pos -= nk1 + nk2
        if pos < nk1:
            tiles.append(w1[chunk][:, pos * TAIL_K:(pos + 1) * TAIL_K])
        else:
            n0 = (pos - nk1) * 128
            tile = np.full((128, TAIL_K), np.nan, np.float32)
            rows = min(128, ck - n0)
            tile[:rows] = w2[n0:n0 + rows, chunk * TAIL_K:(chunk + 1) * TAIL_K]
            tiles.append(tile)
    return tiles


def _rnd(a, dt):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dt).float().numpy()


def _to_tiles(a):
    """(B, H, W, n) -> (B * tiles, 64, n), tiles and pixels in the kernel's order."""
    b, h, w, n = a.shape
    return a.reshape(b, h // 8, 8, w // 8, 8, n).transpose(0, 1, 3, 2, 4, 5).reshape(-1, 64, n)


def _from_tiles(t, b, h, w):
    n = t.shape[-1]
    return t.reshape(b, h // 8, w // 8, 8, 8, n).transpose(0, 1, 3, 2, 4, 5).reshape(b, h, w, n)


def _emulate(x, ln_w, ln_b, w1, b1, w2, b2, dp, residual, dy, eps=1e-5, slab_order=True):
    """The tile on every 8x8 tile of x, and the wrapper's weight products and
    in-order partial sums after it. Returns mlp_bwd_plain's outputs (dx, d
    ln_w, d ln_b, d w1, d b1, d w2, d b2, d s_b). slab_order=False writes the
    dh chunk in unit order (a planted fault)."""
    dt = x.dtype
    b, h, w, c = x.shape
    hid = w2.shape[1]
    pl = mlp_bwd_tc_plan(c, hid)
    ck, nk1, nk2, per = pl["ck"], pl["nk1"], pl["nk2"], pl["per"]
    stream = _stream(pl, *pack_mlp_weights(w1, w2, dt))
    assert len(stream) == pl["tiles"]
    lnw, lnb = ln_w.float().numpy(), ln_b.float().numpy()
    b1f, b2f = b1.float().numpy(), b2.float().numpy()
    xt, dyt = _to_tiles(x.float().numpy()), _to_tiles(dy.to(dt).float().numpy())
    nt = xt.shape[0]
    img = np.arange(nt) // (nt // b)
    # staging: LN in place (tail_ln's statistics), zero from C to CK
    mu = xt.mean(-1, keepdims=True)
    rs = 1 / np.sqrt(((xt - mu) ** 2).mean(-1, keepdims=True) + eps)
    xs = np.zeros((nt, 64, ck), np.float32)
    xs[..., :c] = _rnd((xt - mu) * rs * lnw + lnb, dt)
    dyp = np.zeros_like(xs)
    dyp[..., :c] = dyt
    s = np.ones(nt, np.float32) if dp is None else dp.float().numpy()[img]
    dys = _rnd(dyp * s[:, None, None], dt) if dp is not None else dyp
    part_db2 = dys[..., :c].sum(1)
    dsb = dyt.sum(1) @ b2f
    dh = np.zeros((nt, 64, 2 * hid), np.float32)
    gated = np.zeros((nt, 64, hid), np.float32)
    part_db1 = np.zeros((nt, 2 * hid), np.float32)
    acc = np.zeros((nt, 64, ck), np.float32)
    for j in range(pl["nch"]):
        tl = stream[j * per:(j + 1) * per]
        hh = xs @ np.concatenate(tl[:nk1], axis=1).T
        units = j * TAIL_K + np.arange(TAIL_K)
        ok = units < hid
        ba = np.where(ok, b1f[np.minimum(units, hid - 1)], 0)
        bg = np.where(ok, b1f[hid + np.minimum(units, hid - 1)], 0)
        a, g = hh[..., A_COLS] + ba, hh[..., G_COLS] + bg
        gt = torch.from_numpy(g)
        gl = gelu_exact(gt).numpy()
        dgelu = (0.5 * (1 + torch.erf(gt * 2 ** -0.5))
                 + gt * torch.exp(-0.5 * gt * gt) * (2 * torch.pi) ** -0.5).numpy()
        gv = _rnd(a * gl, dt)
        w2t = np.concatenate([tl[nk1 + i][:min(128, ck - 128 * i)] for i in range(nk2)])
        dg = dys @ w2t
        if dp is not None:
            dsb = dsb + (gv * (dyp @ w2t)).sum((1, 2))
        da, dd = _rnd(dg * gl, dt), _rnd(dg * a * dgelu, dt)
        hc = np.zeros((nt, 64, 2 * TAIL_K), np.float32)
        if slab_order:
            hc[..., A_COLS], hc[..., G_COLS] = da, dd
        else:
            hc[..., :TAIL_K], hc[..., TAIL_K:] = da, dd
        u = units[ok]
        dh[..., u], dh[..., hid + u] = da[..., ok], dd[..., ok]
        gated[..., u] = gv[..., ok]
        csum = hc.sum(1)
        part_db1[:, u], part_db1[:, hid + u] = csum[:, A_COLS][:, ok], csum[:, G_COLS][:, ok]
        for kt in range(nk1):
            acc[..., kt * TAIL_K:(kt + 1) * TAIL_K] += hc @ tl[nk1 + nk2 + kt]
    # epilogue: xhat from x, the LN backward per pixel, dx rounded once
    xh = (xt - mu) * rs
    d = acc[..., :c]
    gg = d * lnw
    dx = (gg - gg.mean(-1, keepdims=True) - xh * (gg * xh).mean(-1, keepdims=True)) * rs
    if residual:
        dx = dx + dyt
    dx = _rnd(dx, dt)
    # the partial rows summed over the tiles in order; d s_b per image
    part = np.concatenate([(d * xh).sum(1), d.sum(1), part_db1, part_db2], axis=1)
    tot = np.zeros(part.shape[1], np.float32)
    for row in part:
        tot += row
    dlnw, dlnb, db1, db2 = np.split(tot, np.cumsum([c, c, 2 * hid]))
    ddp = None if dp is None else np.array([dsb[img == i].sum() for i in range(b)], np.float32)
    # the two weight products from the written operands (float32 sums)
    xn2, dh2 = xs[..., :c].reshape(-1, c), dh.reshape(-1, 2 * hid)
    dw1 = dh2.T @ xn2
    dw2 = dys[..., :c].reshape(-1, c).T @ gated.reshape(-1, hid)
    return (_from_tiles(dx, b, h, w), dlnw, dlnb, dw1, db1, dw2, db2, ddp)


def _inputs(c, hid, dt, seed):
    r = _rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (r.standard_normal(s) * scale).astype(np.float32))
    x, dy = f(2, 8, 16, c).to(dt), f(2, 8, 16, c).to(dt)
    weights = (1 + f(c, scale=0.1), f(c, scale=0.1), f(2 * hid, c, scale=c ** -0.5),
               f(2 * hid, scale=0.1), f(c, hid, scale=hid ** -0.5), f(c, scale=0.1))
    return x, weights, dy


def _max_err(got, ref):
    """Per output: (max abs error, the reference's max abs)."""
    out = []
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
            continue
        r = r.float().numpy() if isinstance(r, torch.Tensor) else r
        assert g.shape == r.shape, (g.shape, r.shape)
        out.append((float(np.abs(g - r).max()), float(np.abs(r).max())))
    return out


@pytest.mark.parametrize("c,hid", WIDTHS)
def test_mlp_bwd_tc_plan(c, hid):
    """The plan mirror: the ring stages and bytes per width (3 stages at C =
    384, where 4 exceed the budget), within the budget; the weight stream's
    tiling (two passes over the slab per chunk)."""
    pl = mlp_bwd_tc_plan(c, hid)
    assert (pl["ws"], pl["bytes"]) == PLANS[c]
    assert pl["bytes"] <= MLP_BWD_BUDGET
    if pl["ws"] < 4:
        assert pl["bytes"] + TAIL_STAGE > MLP_BWD_BUDGET
    assert pl["ck"] % 64 == 0 and c <= pl["ck"] < c + 64
    assert pl["per"] == 2 * pl["nk1"] + pl["nk2"] and pl["nk2"] * 128 >= pl["ck"]
    assert pl["nch"] * TAIL_K >= hid > (pl["nch"] - 1) * TAIL_K


@pytest.mark.parametrize("c,hid", WIDTHS)
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dp", [False, True])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_mlp_bwd_tile_emulation_matches_plain(c, hid, residual, dp, dt):
    """The tile emulated from its tile map on 2 images of 8x16 (4 tiles;
    drop-path scales [1.25, 0.0]) against mlp_bwd_plain on the same inputs,
    every output. float32: the same arithmetic in other orders, 1e-5 of each
    output's max-abs. bf16: the same rounding points, where a float32 sum in
    another order can flip one rounding (LN(x), gated, dys, dh, dx): 1e-2 of
    the max-abs (an indexing fault moves outputs by their whole scale)."""
    x, weights, dy = _inputs(c, hid, dt, 40 + c)
    scale = torch.tensor([1.25, 0.0]) if dp else None
    got = _emulate(x, *weights, scale, residual, dy)
    ref = mlp_bwd_plain(x, *weights, scale, residual, 1e-5, dy)
    tol = 1e-2 if dt == torch.bfloat16 else 1e-5
    for i, (err, mx) in enumerate(_max_err(got, ref)):
        assert mx > 0 and err <= tol * mx, f"output {i}: {err:.3e} > {tol} * {mx:.3e}"


@pytest.mark.parametrize("c,hid", [(128, 340), (27, 71)])
def test_mlp_bwd_emulation_sees_the_slab_order(c, hid):
    """The check is not blind to the dh chunk's column order: dh written in
    unit order (a-units then g-units) instead of the slab's interleaved rows
    moves dx and d ln_w, d ln_b past the bf16 bound."""
    x, weights, dy = _inputs(c, hid, torch.bfloat16, 40 + c)
    scale = torch.tensor([1.25, 0.0])
    got = _emulate(x, *weights, scale, True, dy, slab_order=False)
    ref = mlp_bwd_plain(x, *weights, scale, True, 1e-5, dy)
    errs = _max_err(got, ref)
    assert all(errs[i][0] > 1e-2 * errs[i][1] for i in (0, 1, 2)), errs


def test_mlp_bwd_emulation_matches_pallas_interpret():
    """One tiny case (C 16, hid 42, residual, drop-path [1.25, 0.0]) of the
    emulated tile in float32 against the JAX package's _mlp_bwd_call run in
    interpret mode: 1e-4 of each output's max-abs (the Pallas GELU is a
    polynomial 1.5e-6 from erf)."""
    import jax.numpy as jnp

    from mp_hsir_tpu.ops.pallas_vjp import _mlp_bwd_call

    c, hid = 16, 42
    x, (lw, lb, w1, b1, w2, b2), dy = _inputs(c, hid, torch.float32, 7)
    dp = torch.tensor([1.25, 0.0])
    got = _emulate(x, lw, lb, w1, b1, w2, b2, dp, True, dy)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    want = _mlp_bwd_call(j(x), j(dy), j(lw), j(lb), j(w1.t().contiguous()), j(b1),
                         j(w2.t().contiguous()), j(b2), j(dp), hidden=hid, eps=1e-5,
                         residual=True, interpret=True)
    want = [np.asarray(v, np.float32) for v in want]
    want[3], want[5] = want[3].T, want[5].T  # JAX's (in, out) weight layouts
    for i, (g, wv) in enumerate(zip(got, want)):
        err, mx = float(np.abs(g - wv.reshape(g.shape)).max()), float(np.abs(wv).max())
        assert err <= 1e-4 * mx, f"output {i}: {err:.3e} > 1e-4 * {mx:.3e}"


def test_mlp_wrapper_backward_runs_plain_on_cpu():
    """On a CPU tensor the wrapper's backward is the plain one, bf16 included:
    the gradients autograd gives equal mlp_bwd_plain's."""
    c, hid = 36, 95
    x, weights, dy = _inputs(c, hid, torch.bfloat16, 3)
    dp = torch.tensor([1.25, 0.0])
    ts = [t.clone().requires_grad_(True) for t in (x, *weights, dp)]
    out = mlp(*ts[:7], residual=True, dp_scale=ts[7])
    got = torch.autograd.grad(out, ts, dy)
    ref = mlp_bwd_plain(x, *weights, dp, True, 1e-5, dy)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert torch.equal(g, r), i
