"""The float32 GDFN tile (K5 in float32, ``gdfn_f32_kernel`` in
csrc/gdfn.cu: 3xTF32 on m16n8k8) without a card: the plan mirror
``gdfn_f32_plan`` against hand-computed bytes, the float32 pack
(``pack_gdfn_f32``, rows padded to 4), and the tile emulated in numpy from
its own tile map (per 8x8 tile the 10x10 halo with LN in float32, zero
outside the image after the LN, padded to 112 rows and to 32-channel chunks;
per hidden chunk of 64 units project_in from the chunk's x1 and x2 rows of
the pack (the kernel's two passes: the same sums), k8 step by k8 step with
the three TF32 products summed toward zero and added in float32; the
depthwise 3x3 by fmaf in tap order; gelu(x1) * x2 in float32;
project_out's sums over all chunks in the same k8 steps; y = sums + x; the
exit 1x1 from proj_w's pack) against ``gdfn_plain`` in float32 at the
presets' (C, hid, Co) and tiny widths; four planted faults the check must
catch; the plain version against the JAX package's ``fused_ln_gdfn_nhwc``
in interpret mode. The kernel itself is held against the plain version on
the card by tests/test_torch_cuda.py and chip_smoke.py. Imports JAX only in
the test that compares with it."""

import numpy as np
import pytest
import torch

from mp_hsir_tpu_torch.ops.basic import gelu_exact
from mp_hsir_tpu_torch.ops.kernels.gdfn import (
    GDFN_BUDGET, GDFN_F32_K, GDFN_F32_STATIC, gdfn, gdfn_f32_plan, gdfn_plain, pack_gdfn_f32,
)
from mp_hsir_tpu_torch.ops.kernels.spectral import F32_K
from test_torch_apply_f32 import _fma, _tiles
from tf32_emulation import mma
from torch_port_inputs import normal as _n, rng as _rng, tensor as _t
import torch_threads  # noqa: E402,F401  (one compute thread per process)

LIMIT = 232448  # the H100's shared memory per block (opt-in)
EPS = 1e-5
TOL = 2e-6  # of the output's max-abs: float32 both sides, sums in other orders
# the plan by hand: taps [9][128] + LN mean, rstd [2][112] + gated [64][68] +
# t [100][136] floats, then 4 ring stages of the larger of a project_in
# pass's chunk ([112 + 64][36] floats, 25,344 B) and a w_out tile ([128][68]
# floats, 34,816 B); the static 448 B (the halo rows' sources)
FIXED = 4 * (9 * 128 + 2 * 112 + 64 * 68 + 100 * 136)
PLAN_BYTES = FIXED + 4 * 34816
# (C, Co) -> (halo chunks, exit ring stages, the exit's bytes over the dead
# front: y [64][CP + 4] + stages of [NP][36] floats)
PLANS = {(32, 16): (1, 3, 4 * (64 * 36 + 3 * 32 * 36)),
         (54, 27): (2, 3, 4 * (64 * 68 + 3 * 32 * 36)),
         (64, 32): (2, 3, 4 * (64 * 68 + 3 * 32 * 36)),
         (128, 64): (4, 3, 4 * (64 * 132 + 3 * 64 * 36)),
         (192, 96): (6, 3, 4 * (64 * 196 + 3 * 96 * 36)),
         (256, 128): (8, 3, 4 * (64 * 260 + 3 * 128 * 36)),
         (384, 192): (12, 3, 4 * (64 * 388 + 3 * 192 * 36)),
         (384, 384): (12, 2, 4 * (64 * 388 + 2 * 384 * 36))}
# (C, hid, Co): the presets' PromptFusion calls (flagship fusion1 / fusion2,
# remote sensing fusion1 / fusion2: the last hidden chunk ragged at each,
# hid 1021 odd) and tiny widths (hid 85 and 170; C = 54 and odd 27: rows not
# 16-byte multiples)
PRESETS = [(128, 340, 64), (256, 680, 128), (192, 510, 96), (384, 1021, 192)]
TINY = [(32, 85, 16), (64, 170, 32), (54, 143, 27), (27, 71, 13)]
VARIANTS = [(True, True), (False, True), (True, False), (False, False)]


def _untile(o, h, w):
    """(B, T, 64, C) tiles in row-major order -> (B, H, W, C)."""
    b, _, _, c = o.shape
    tx = w // 8
    return np.stack([np.stack([o[:, ty * tx + i].reshape(b, 8, 8, c) for i in range(tx)], axis=2)
                     for ty in range(h // 8)], axis=1).reshape(b, h, w, c)


def _emulate(x, ln_w, ln_b, w_in, w_dw, w_out, residual=False, proj_w=None, three=True,
             chained=False, halo_ln0=False, exit_first=False):
    """The tile on float32 inputs (gdfn_plain's arguments): the output (B, H,
    W, Co). three=False: one TF32 product; chained: the products summed on
    the tensor cores across all of K; halo_ln0: the halo rows outside the
    image left at LN(0) = ln_b; exit_first: the exit 1x1 read before the
    residual (the planted faults)."""
    xf = x.numpy()
    b, h, w, c = xf.shape
    hid, k = w_out.shape[1], GDFN_F32_K
    mu = xf.mean(-1, keepdims=True)
    rs = np.float32(1) / np.sqrt(((xf - mu) ** 2).mean(-1, keepdims=True) + np.float32(EPS))
    xn = (xf - mu) * rs * ln_w.numpy() + ln_b.numpy()
    pl = gdfn_f32_plan(c)
    ck = F32_K * pl["nk"]
    wi, taps, wo, wp = (None if t is None else t.numpy() for t in pack_gdfn_f32(w_in, w_dw, w_out,
                                                                                  proj_w))
    halo = np.zeros((b, (h // 8) * (w // 8), 112, ck), np.float32)
    halo[:, :, :100, :c] = _tiles(xn)
    if halo_ln0:
        inside = _tiles(np.ones((b, h, w, 1), np.float32))[..., 0] > 0
        halo[:, :, :100, :c] = np.where(inside[..., None], halo[:, :, :100, :c], ln_b.numpy())
    n_tiles = halo.shape[1]
    cw = -(-c // 64) * 64
    acc = np.zeros((b, n_tiles, 64, cw), np.float32)
    for j0 in range(0, hid, k):
        n = min(k, hid - j0)
        wc = np.zeros((2 * k, ck), np.float32)  # the chunk's x1 rows, then its x2 rows
        wc[:n, :wi.shape[1]], wc[k:k + n, :wi.shape[1]] = wi[j0:j0 + n], wi[hid + j0:hid + j0 + n]
        tp = np.zeros((9, 2 * k), np.float32)
        tp[:, :n], tp[:, k:k + n] = taps[j0:j0 + n].T, taps[hid + j0:hid + j0 + n].T
        t = mma(np.zeros((b, n_tiles, 112, 2 * k), np.float32), halo, wc.T, three, chained)
        t = t[:, :, :100].reshape(b, n_tiles, 10, 10, 2 * k)
        s = np.zeros((b, n_tiles, 8, 8, 2 * k), np.float32)
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            s = _fma(s, t[:, :, dy:dy + 8, dx:dx + 8], tp[tap])
        s = s.reshape(b, n_tiles, 64, 2 * k)
        gated = (gelu_exact(torch.from_numpy(s[..., :k])) * torch.from_numpy(s[..., k:])).numpy()
        wt = np.zeros((cw, k), np.float32)  # w_out's [C][hid4] at the chunk's columns
        cols = wo[:, j0:j0 + k]
        wt[:c, :cols.shape[1]] = cols
        acc = mma(acc, gated, wt.T, three, chained)
    y = acc[..., :c]
    ut = _tiles(xf, 8, 0)
    yr = ut + y if residual else y
    if wp is None:
        return _untile(yr, h, w)
    co, cp = wp.shape[0], pl["cp"]
    ya = np.zeros((b, n_tiles, 64, cp), np.float32)
    ya[..., :c] = y if exit_first else yr
    bm = np.zeros((cp, -(-co // 32) * 32), np.float32)
    bm[:wp.shape[1], :co] = wp.T
    o = mma(np.zeros((b, n_tiles, 64, bm.shape[1]), np.float32), ya, bm, three, chained)
    return _untile(o[..., :co], h, w)


def _inputs(c, hid, co, proj, seed, h, w):
    """gdfn_plain's float32 arguments (x, ln_w, ln_b, w_in, w_dw, w_out),
    proj_w or None; a nonzero LN bias (the halo's zero rows after the LN)."""
    r = _rng(seed)
    args = [_t(_n(r, (1, h, w, c))), 1 + _t(_n(r, (c,), 0.1)), _t(_n(r, (c,), 0.5)),
            _t(_n(r, (2 * hid, c, 1, 1), c ** -0.5)), _t(_n(r, (2 * hid, 1, 3, 3), 1 / 3)),
            _t(_n(r, (c, hid, 1, 1), hid ** -0.5))]
    return args, _t(_n(r, (co, c, 1, 1), c ** -0.5)) if proj else None


def _case(c, hid, co, residual, proj, h=8, w=16, **faults):
    args, pw = _inputs(c, hid, co, proj, 700 + c, h, w)
    got = _emulate(*args, residual=residual, proj_w=pw, **faults)
    ref = gdfn_plain(*args, residual=residual, proj_w=pw).numpy()
    return got, ref


def _rel(got, ref):
    return float(np.abs(got - ref).max()) / float(np.abs(ref).max())


@pytest.mark.parametrize("c,co", list(PLANS))
def test_gdfn_f32_plan(c, co):
    """The plan mirror against the bytes by hand: the same front at every
    width (the halo streams; 4 ring stages), the halo's 32-channel chunks,
    and the exit's y and ring over the dead front within the front's bytes
    (3 stages where they fit, else 2); the rows of t, the gated tile and the
    staged chunks as the kernel's ldmatrix and float2 accesses want them."""
    pl = gdfn_f32_plan(c, co)
    nk, cs, exit_ = PLANS[(c, co)]
    assert pl["bytes"] == PLAN_BYTES == 216576 and pl["smem"] == 217024 == (
        PLAN_BYTES + GDFN_F32_STATIC) <= LIMIT
    assert pl["bytes"] <= GDFN_BUDGET and pl["ws"] == 4 and pl["stage"] == 34816
    assert (pl["nk"], pl["cs"], pl["exit"]) == (nk, cs, exit_) and exit_ <= pl["bytes"]
    assert pl["cp"] % 32 == 0 and c <= pl["cp"] < c + 32 and pl["ldy"] % 32 == 4
    assert gdfn_f32_plan(c)["bytes"] == pl["bytes"] and gdfn_f32_plan(c)["exit"] == 0
    assert (2 * GDFN_F32_K + 8) % 32 == 8 and (GDFN_F32_K + 4) % 32 == 4


@pytest.mark.parametrize("c,hid,co", [(54, 85, 27), (128, 1021, 64), (64, 170, 32),
                                      (27, 71, 13)])
def test_pack_gdfn_f32_layout(c, hid, co):
    """pack_gdfn_f32: w_in [2 hid][C4], the taps [2 hid][9], w_out [C][hid4]
    and proj_w [Co][C4] in float32, contiguous, rows padded with zeros to a
    multiple of 4 only where they are not one (views of float32 weights that
    need no padding); the values the torch layouts'."""
    r = _rng(8 + c)
    w_in, w_dw = _t(_n(r, (2 * hid, c, 1, 1))), _t(_n(r, (2 * hid, 1, 3, 3)))
    w_out, proj = _t(_n(r, (c, hid, 1, 1))), _t(_n(r, (co, c, 1, 1)))
    wi, taps, wo, wp = pack_gdfn_f32(w_in, w_dw, w_out, proj)
    c4, hid4 = -(-c // 4) * 4, -(-hid // 4) * 4
    assert (wi.shape, taps.shape, wo.shape, wp.shape) == ((2 * hid, c4), (2 * hid, 9),
                                                          (c, hid4), (co, c4))
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in (wi, taps, wo, wp))
    assert (wi.data_ptr() == w_in.data_ptr()) == (c % 4 == 0)
    assert (wo.data_ptr() == w_out.data_ptr()) == (hid % 4 == 0)
    assert torch.equal(wi[:, :c], w_in.reshape(2 * hid, c))
    assert torch.equal(taps, w_dw.reshape(2 * hid, 9))
    assert torch.equal(wo[:, :hid], w_out.reshape(c, hid))
    assert torch.equal(wp[:, :c], proj.reshape(co, c))
    assert not wi[:, c:].any() and not wo[:, hid:].any() and not wp[:, c:].any()


@pytest.mark.parametrize("residual,proj", VARIANTS)
@pytest.mark.parametrize("c,hid,co", PRESETS + TINY)
def test_gdfn_f32_emulation_matches_plain(c, hid, co, residual, proj):
    """The emulated tile against gdfn_plain in float32 on an 8x16 map (2
    tiles; every halo meets the image's edge and the other tile): within
    2e-6 of the output's max-abs."""
    got, ref = _case(c, hid, co, residual, proj)
    assert got.shape == ref.shape
    assert _rel(got, ref) <= TOL, _rel(got, ref)


def test_gdfn_f32_emulation_matches_plain_on_interior_tiles():
    """The same on a 24x24 map (9 tiles, one with neighbours on every side)
    at a tiny width with the residual and the exit 1x1."""
    got, ref = _case(64, 170, 32, True, True, h=24, w=24)
    assert _rel(got, ref) <= TOL, _rel(got, ref)


@pytest.mark.parametrize("fault", [dict(three=False), dict(chained=True), dict(halo_ln0=True),
                                   dict(exit_first=True)],
                         ids=["one-tf32-product", "chained-k8-sums", "halo-at-ln0",
                              "exit-before-residual"])
def test_gdfn_f32_emulation_sees_the_faults(fault):
    """The check is not blind: one TF32 product instead of three (10-bit
    operands), the k8 steps' sums chained on the tensor cores (each add
    truncated) instead of flushed into float32, the halo rows outside the
    image left at LN(0) = ln_b, and the exit 1x1 read before the residual
    each break the bound at the remote-sensing fusion2 widths (C = 384, hid
    1021, Co = 192) with the residual and the exit 1x1."""
    got, ref = _case(384, 1021, 192, True, True, **fault)
    assert _rel(got, ref) > TOL, _rel(got, ref)


def test_gdfn_f32_wrapper_runs_plain_on_cpu():
    """On a CPU tensor the wrapper is its plain version and counts no tile
    launch."""
    from mp_hsir_tpu_torch.ops.kernels import _route

    args, pw = _inputs(54, 143, 27, True, 3, 8, 16)
    _route.reset_counters()
    assert torch.equal(gdfn(*args, residual=True, proj_w=pw),
                       gdfn_plain(*args, residual=True, proj_w=pw))
    assert _route.COUNTERS["gdfn_f32"].launches == 0


def test_gdfn_plain_and_emulation_match_pallas_interpret():
    """gdfn_plain and the emulated tile against the JAX package's
    fused_ln_gdfn_nhwc in interpret mode (float32, residual, the exit 1x1,
    a nonzero LN bias, a ragged last hidden chunk), at the tolerance
    tests/test_torch_kernels.py holds the plain version to."""
    import jax.numpy as jnp

    from mp_hsir_tpu.ops import pallas_attention as PA
    from torch_port_inputs import oihw

    c, hid, co, h, w = 32, 85, 16, 16, 24
    r = _rng(41)
    x = _n(r, (1, h, w, c))
    ln_w, ln_b = 1 + _n(r, (c,), 0.1), _n(r, (c,), 0.5)
    w_in, w_dw = _n(r, (1, 1, c, 2 * hid), c ** -0.5), _n(r, (3, 3, 1, 2 * hid), 1 / 3)
    w_out, proj = _n(r, (1, 1, hid, c), hid ** -0.5), _n(r, (1, 1, c, co), c ** -0.5)
    want = np.asarray(PA.fused_ln_gdfn_nhwc(
        jnp.asarray(x), jnp.asarray(ln_w), jnp.asarray(ln_b), jnp.asarray(w_in),
        jnp.asarray(w_dw), jnp.asarray(w_out), residual=True, proj_w=jnp.asarray(proj),
        interpret=True))
    args = [_t(x), _t(ln_w), _t(ln_b), oihw(w_in), oihw(w_dw), oihw(w_out)]
    plain = gdfn_plain(*args, residual=True, proj_w=oihw(proj)).numpy()
    got = _emulate(*args, residual=True, proj_w=oihw(proj))
    np.testing.assert_allclose(plain, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
