"""The bf16 window-attention backward (K8) without a card: the plan mirror
``window_bwd_tc_plan``, and both of its tiles emulated in numpy from their
own tile maps (tile 1, ``window_attention_bwd_tc_kernel``: per window of the
rolled frame, LN(x) and the rounded dy staged on rows padded to the K chunk,
per head q, k, v from the forward's head-major pack and do from
``pack_proj_t_weight``, all padded to the head width, S, A, dA, dS, dq from
registers, dk and dv from the staged rnd(dS) and rnd(A), the per-window
partial row dS | bp; tile 2, ``dwconv_dx_tc_kernel`` without its stencil:
the 64-channel chunks of dqkv against the rows of the torch qkv weight, the
column sums, the LayerNorm epilogue with x at the roll-back) and the
wrapper's weight products and in-order sum, at the rounding points of
``window_attention_bwd_plain``, against it; one tiny case against the JAX
package's backward (``_win_bwd_call``) in interpret mode. The kernels
themselves are held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py. Imports JAX only in the test
that compares with it."""

import numpy as np
import pytest
import torch

from mp_hsir_tpu_torch.ops.kernels.mlp import TAIL_MAX_C
from mp_hsir_tpu_torch.ops.kernels.spectral import DX_LDT, STATS_BUDGET, dwconv_dx_plan
from mp_hsir_tpu_torch.ops.kernels.window_attention import (
    TC_LD, pack_proj_t_weight, pack_qkv_weight, window_attention,
    window_attention_bwd_plain, window_bwd_tc_plan,
)
from mp_hsir_tpu_torch.ops.window import shifted_region_map
from torch_port_inputs import normal as _n, rng as _rng, uniform as _u
import torch_threads  # noqa: E402,F401  (one compute thread per process)

# (C, heads) of every window call of the presets' train steps (dh 32, 64, 48
# and 96) and C = 36 and 27 (dh 18 and 9, padded to 32 and 16; 3C = 108 and
# 81: a ragged last chunk in tile 2)
WIDTHS = [(64, 2), (128, 4), (256, 8), (128, 2), (96, 2), (192, 4), (384, 8), (192, 2), (36, 2),
          (27, 3)]
# tile 1: (padded head width, ring stages, dynamic bytes); tile 2: (ring
# stages, dynamic bytes)
PLANS = {(64, 2): (32, 6, 84992, 3, 55296), (128, 4): (32, 6, 101376, 3, 79872),
         (256, 8): (32, 6, 134144, 3, 129024), (128, 2): (64, 4, 126976, 3, 79872),
         (96, 2): (48, 5, 116480, 3, 79872), (192, 4): (48, 5, 132864, 3, 104448),
         (384, 8): (48, 5, 182016, 3, 178176), (192, 2): (96, 2, 150528, 3, 104448),
         (36, 2): (32, 6, 84992, 3, 55296), (27, 3): (16, 6, 62976, 3, 55296)}
EPS = 1e-5
LIMIT = 232448  # the H100's shared memory per block (opt-in)


def _rnd(a, dt):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dt).float().numpy()


def _windows(a):
    """(B, H, W, n) -> (B H/8 W/8, 64, n), windows in row-major order."""
    b, h, w, n = a.shape
    return a.reshape(b, h // 8, 8, w // 8, 8, n).transpose(0, 1, 3, 2, 4, 5).reshape(-1, 64, n)


def _unwindows(t, b, h, w):
    n = t.shape[-1]
    return t.reshape(b, h // 8, w // 8, 8, 8, n).transpose(0, 1, 3, 2, 4, 5).reshape(b, h, w, n)


def _ln_stats(a):
    mu = a.mean(-1, keepdims=True)
    rs = 1 / np.sqrt(((a - mu) ** 2).mean(-1, keepdims=True) + EPS)
    return (a - mu) * rs, rs


def _tile1(x, lnw, lnb, wq, bqkv, bias, wpt, heads, shift, dy, dpool, dt, transposed=True):
    """Tile 1 on every window: (xn, o, dyt, dqkv) as window rows [nwin][64][n]
    and the partial rows [nwin][nH 4096 + C]. transposed=False computes dk
    with rnd(dS) where rnd(dS)^T belongs (a planted fault)."""
    b, h, w, c = x.shape
    pl = window_bwd_tc_plan(c, heads)
    dh, dhp, kx = c // heads, pl["dhp"], pl["kx"]
    scale = dh ** -0.5
    nwin = b * (h // 8) * (w // 8)
    # the staged rows, zero from C to kx: LN(x) in place, rounded; dy + dpool / 64
    xr = _windows(np.roll(x, (-shift, -shift), axis=(1, 2)))
    xhat, _ = _ln_stats(xr)
    xs = np.zeros((nwin, 64, kx), np.float32)
    xs[..., :c] = _rnd(xhat * lnw + lnb, dt)
    ysf = _windows(dy) + dpool.reshape(nwin, 1, c) / 64
    ys = np.zeros_like(xs)
    ys[..., :c] = _rnd(ysf, dt)
    lab = None  # the region labels of each window's tokens, the same in every image
    if shift:
        lab = np.tile(_windows(shifted_region_map(h, w, 8, shift)[None, :, :, None])[..., 0],
                      (b, 1))
    o = np.zeros((nwin, 64, c), np.float32)
    dqkv = np.zeros((nwin, 64, 3 * c), np.float32)
    pbias = np.zeros((nwin, heads, 64, 64), np.float32)
    for hd in range(heads):
        def head_bias(s):
            out = np.zeros(dhp, np.float32)
            out[:dh] = bqkv[s * c + hd * dh:s * c + (hd + 1) * dh]
            return out

        q, k, v = (_rnd(xs @ wq[hd, s].T + head_bias(s), dt) for s in range(3))
        do = _rnd(ys @ wpt[hd].T, dt)
        s_ = q @ np.swapaxes(k, -1, -2) * scale + bias[hd]
        if lab is not None:
            s_ = s_ - 100.0 * (lab[:, :, None] != lab[:, None, :])
        e = np.exp(s_ - s_.max(-1, keepdims=True))
        a = e / e.sum(-1, keepdims=True)
        ar = _rnd(a, dt)
        oh = _rnd(ar @ v, dt)
        da = do @ np.swapaxes(v, -1, -2)
        ds = a * (da - (a * da).sum(-1, keepdims=True))
        pbias[:, hd] = ds
        g = _rnd(ds, dt)
        dq = g @ k * scale
        dk = (np.swapaxes(g, -1, -2) if transposed else g) @ q * scale
        dv = np.swapaxes(ar, -1, -2) @ do
        cols = hd * dh + np.arange(dh)
        o[..., cols] = oh[..., :dh]
        for s, val in enumerate((dq, dk, dv)):
            dqkv[..., s * c + cols] = _rnd(val[..., :dh], dt)
    part = np.concatenate([pbias.reshape(nwin, -1), ysf.sum(1)], -1)
    return xs[..., :c], o, ys[..., :c], dqkv, part


def _tile2(dqkv, wrows, x, lnw, shift, dt):
    """Tile 2 on every window (K = 3C in 64-channel chunks): dx in x's frame
    and the partial rows [nwin][3C + 2C] (column sums | d ln_w | d ln_b)."""
    b, h, w, c = x.shape
    k3 = 3 * c
    nck = dwconv_dx_plan(c, k3, stencil=False)["nck"]
    dxn = np.zeros(dqkv.shape[:2] + (c,), np.float32)
    colsum = np.zeros((dqkv.shape[0], k3), np.float32)
    for ch in range(nck):
        ks = np.arange(64 * ch, min(64 * ch + 64, k3))
        colsum[:, ks] = dqkv[..., ks].sum(1)
        dxn += dqkv[..., ks] @ wrows[ks, :c]
    xhat, rs = _ln_stats(_windows(np.roll(x, (-shift, -shift), axis=(1, 2))))  # the roll-back
    g = dxn * lnw
    dx = (g - g.mean(-1, keepdims=True) - xhat * (g * xhat).mean(-1, keepdims=True)) * rs
    dx = np.roll(_unwindows(_rnd(dx, dt), b, h, w), (shift, shift), axis=(1, 2))
    return dx, np.concatenate([colsum, (dxn * xhat).sum(1), dxn.sum(1)], -1)


def _emulate(x, lnw, lnb, wqkv, bqkv, bias, wp, bp, heads, shift, dy, dpool, transposed=True):
    """Both tiles, the two weight products and the in-order sum of the
    concatenated partial rows: the outputs of window_attention_bwd_plain as
    numpy arrays."""
    dt = x.dtype
    b, h, w, c = x.shape
    wq = pack_qkv_weight(wqkv, heads, dt).float().numpy()
    wpt = pack_proj_t_weight(wp, heads, dt).float().numpy()
    f = lambda t: t.float().numpy()  # noqa: E731
    xf = f(x)
    xn, o, dyt, dqkv, part1 = _tile1(xf, f(lnw), f(lnb), wq, f(bqkv), f(bias), wpt, heads, shift,
                                     f(dy.to(dt)), f(dpool.to(dt)), dt, transposed)
    dx, part2 = _tile2(dqkv, f(wqkv.to(dt)), xf, f(lnw), shift, dt)
    part = np.concatenate([part1, part2], -1)
    assert part.shape[1] == heads * 4096 + 6 * c
    tot = np.zeros(part.shape[1], np.float32)
    for row in part:  # sum_parts: the windows in order
        tot += row
    nb = heads * 4096
    dwqkv = dqkv.reshape(-1, 3 * c).T @ xn.reshape(-1, c)
    dwp = dyt.reshape(-1, c).T @ o.reshape(-1, c)
    dbias, dbp, dbqkv, dlnw, dlnb = np.split(tot, np.cumsum([nb, c, 3 * c, c]))
    return dx, dlnw, dlnb, dwqkv, dbqkv, dbias.reshape(heads, 64, 64), dwp, dbp


def _inputs(c, heads, dt, seed, b=2, h=16, w=16):
    """(x, ln_w, ln_b, wqkv, bqkv, rel_bias, wp, bp) in the torch layouts and
    the cotangents (dout, dpool), from one numpy seed."""
    r = _rng(seed)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    fwd = (t(_n(r, (b, h, w, c))).to(dt), t(1 + _n(r, (c,), 0.1)), t(_n(r, (c,), 0.1)),
           t(_u(r, (3 * c, c), c)), t(_u(r, (3 * c,), c)), t(_n(r, (heads, 64, 64), 0.02)),
           t(_u(r, (c, c), c)), t(_u(r, (c,), c)))
    return fwd, (t(_n(r, (b, h, w, c))).to(dt), t(_n(r, (b, h // 8, w // 8, c))).to(dt))


def _errs(got, ref):
    out = []
    for g, r in zip(got, ref):
        r = r.float().numpy()
        assert g.shape == r.shape, (g.shape, r.shape)
        out.append((float(np.abs(g - r).max()), float(np.abs(r).max())))
    return out


def _case(c, heads, shift, dt, b=2, transposed=True):
    fwd, (dout, dpool) = _inputs(c, heads, dt, 70 + c + heads, b=b)
    got = _emulate(*fwd, heads, shift, dout, dpool, transposed)
    ref = window_attention_bwd_plain(*fwd, heads, shift, EPS, dout, dpool)
    return _errs(got, ref)


@pytest.mark.parametrize("c,heads", WIDTHS)
def test_window_bwd_tc_plan(c, heads):
    """The plan mirror: tile 1 at the padded head width with the forward
    tile's ring stages, within the budget with its 256 static bytes; tile 2
    without the stencil at K = 3C, 3 ring stages of the cotangent chunk and
    the weight rows, every chunk of the 3C channels."""
    pl = window_bwd_tc_plan(c, heads)
    dhp, stages, one, stages2, two = PLANS[c, heads]
    assert (pl["dhp"], pl["stages"], pl["bytes"]) == (dhp, stages, one)
    assert pl["kx"] % 64 == 0 and pl["kx"] - 64 < c <= pl["kx"] and c // heads <= dhp
    assert one + 256 <= LIMIT and c <= TAIL_MAX_C
    assert one == 2 * (2 * 64 * (pl["kx"] + 8) + 4 * 64 * (dhp + 8) + 2 * 64 * TC_LD
                       + stages * dhp * TC_LD)
    dx = pl["dx"]
    assert (dx["stages"], dx["bytes"]) == (stages2, two) and two <= STATS_BUDGET
    assert dx["stage"] == 2 * 64 * DX_LDT + 2 * 64 * (dx["ck"] + 8)
    assert dx["nck"] * 64 >= 3 * c > (dx["nck"] - 1) * 64


@pytest.mark.parametrize("c,heads", WIDTHS)
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_window_bwd_tiles_emulation_matches_plain(c, heads, shift, dt):
    """Both tiles emulated from their tile maps on 2 images of 16x16 (8
    windows; shifted: the region mask and the roll-back wrapping) against
    window_attention_bwd_plain, every output. float32: the same arithmetic in
    other orders and on padded head widths, 1e-4 of each output's max-abs.
    bf16: the same rounding points (LN(x), dy, q, k, v, do, A, o, dS, dqkv,
    dx), where a float32 sum in another order can flip one rounding: 3e-2."""
    tol = 3e-2 if dt == torch.bfloat16 else 1e-4
    for i, (err, mx) in enumerate(_case(c, heads, shift, dt, b=2 if c <= 192 else 1)):
        assert mx > 0 and err <= tol * mx, f"output {i}: {err:.3e} > {tol} * {mx:.3e}"


@pytest.mark.parametrize("c,heads", [(64, 2), (27, 3)])
def test_window_bwd_emulation_sees_the_transpose(c, heads):
    """The check is not blind to dk's orientation: dk from rnd(dS) where
    rnd(dS)^T belongs moves dx and d wqkv past the bf16 bound."""
    errs = _case(c, heads, 4, torch.bfloat16, transposed=False)
    assert all(errs[i][0] > 3e-2 * errs[i][1] for i in (0, 3)), errs


def test_window_bwd_emulation_matches_pallas_interpret():
    """One tiny case (C 16, 2 heads, shifted, 2 images of 16x16) of both
    emulated tiles in float32 against jax.vjp of the JAX package's fused
    window attention in interpret mode, whose backward is _win_bwd_call (the
    roll inside the differentiated function, as the port rolls in the
    kernel): 1e-4 of each gradient's max-abs."""
    import jax
    import jax.numpy as jnp

    from mp_hsir_tpu.ops import pallas_attention as PA

    c, heads, shift = 16, 2, 4
    fwd, (dout, dpool) = _inputs(c, heads, torch.float32, 9)
    got = _emulate(*fwd, heads, shift, dout, dpool)
    h, w = fwd[0].shape[1:3]
    region = jnp.asarray(shifted_region_map(h, w, 8, shift))

    def jfn(x, lw, lb, wq, bq, rb, wp, bp):
        xr = jnp.roll(x, (-shift, -shift), axis=(1, 2))
        return PA.fused_ln_window_attention_nhwc(xr, lw, lb, wq, bq, rb, wp, bp, region, heads,
                                                 interpret=True)

    x, lw, lb, wq, bq, rb, wp, bp = (a.numpy() for a in fwd)
    args = [jnp.asarray(a) for a in (x, lw, lb, wq.T, bq, rb, wp.T, bp)]
    out, pull = jax.vjp(jfn, *args)
    want = pull(type(out)((jnp.asarray(dout.numpy()), jnp.asarray(dpool.numpy()))))
    mine = (got[0], got[1], got[2], got[3].T, got[4], got[5], got[6].T, got[7])
    for i, (g, wv) in enumerate(zip(mine, want)):
        wv = np.asarray(wv)
        err, mx = float(np.abs(g - wv.reshape(g.shape)).max()), float(np.abs(wv).max())
        assert mx > 0 and err <= 1e-4 * mx, f"gradient {i}: {err:.3e} > 1e-4 * {mx:.3e}"


def test_window_wrapper_backward_runs_plain_on_cpu():
    """On a CPU tensor the wrapper's backward is the plain one, bf16 included:
    the gradients autograd gives equal window_attention_bwd_plain's."""
    fwd, (dout, dpool) = _inputs(36, 2, torch.bfloat16, 3)
    ts = [t.clone().requires_grad_(True) for t in fwd]
    out = window_attention(*ts, 2, shift=4)
    got = torch.autograd.grad(out, ts, (dout, dpool))
    ref = window_attention_bwd_plain(*fwd, 2, 4, EPS, dout, dpool)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert torch.equal(g, r), i
