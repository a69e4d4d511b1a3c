"""The float32 PGSSTB tail tile (``mlp_tail_f32`` in csrc/mlp_tail.cuh: K6's
float32 body and the float32 spectral apply kernel's tail) without a card:
the plan mirror ``tail_f32_plan``, and the tile emulated in numpy from its
own tile map (``pack_mlp_weights``' float32 slabs, the ring's tile order
per output group of at most 384 channels, the slab's a|g rows, the 3xTF32
split of every fragment with TF32 rounding emulated as ``cvt.rna``, each
k8 step's products summed on the tensor cores toward zero, then in float32)
against
``mlp_plain`` and ``spectral_apply_plain`` in float32; two planted faults
the check must catch; one case against JAX's ``_mlp_fwd_call`` in interpret
mode. The kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py. Imports JAX only in the test
that compares with it."""

import numpy as np
import pytest
import torch

from mp_hsir_tpu_torch.ops.basic import gelu_exact
from mp_hsir_tpu_torch.ops.kernels.mlp import (
    TAIL_F32_BUDGET, TAIL_K, TAIL_MAX_C, TAIL_STAGE_F32, mlp_plain, pack_mlp_weights,
    tail_f32_plan,
)
from mp_hsir_tpu_torch.ops.kernels.spectral import spectral_apply_plain
from tf32_emulation import mma as _mma, split as _split, tf32 as _tf32
from torch_port_inputs import rng as _rng
import torch_threads  # noqa: E402,F401  (one compute thread per process)

# (C, hid): C = 16 and 96 pad to CK = 64 and 128 (a half-width fc2 tile at
# 96); 64 the flagship's first level; 400 pads to 448, past the 384 channels
# fc2's register slice holds: two output groups (384 + 64), fc1 run per
# group. hid never a multiple of 64 (a ragged last chunk; 255 odd).
WIDTHS = [(16, 42), (64, 170), (96, 255), (400, 100)]
# the plan per width: (ring stages, dynamic bytes); 4 stages exceed the
# budget at C = 384, 3 at C = 400
PLANS = {16: (4, 174080), 64: (4, 174080), 96: (4, 190464), 128: (4, 190464),
         192: (4, 206848), 256: (4, 223232), 384: (3, 221184), 400: (2, 202752)}
TOL = 1e-5  # of the plain output's max-abs: float32 both sides, sums in other orders
# slab column of each unit of a chunk: a-unit 16 q + i at 32 q + i, its g 16 further
A_COLS = np.array([32 * q + i for q in range(4) for i in range(16)])
G_COLS = A_COLS + 16


def _stream(w1p, w2p, pl, n0, nk2):
    """The ring's tiles for the output group from channel n0, in
    TailRingT::issue's order: per hidden chunk the slab's nk1 depth tiles
    ([128][64]), then the group's nk2 fc2 tiles (channel rows n0 + 128 i ..,
    the chunk's 64 unit columns; rows past CK never copied, NaN here)."""
    ck = pl["ck"]
    tiles = []
    for j in range(pl["nch"]):
        for kt in range(pl["nk1"]):
            tiles.append(w1p[j][:, kt * TAIL_K:(kt + 1) * TAIL_K])
        for i in range(nk2):
            n = n0 + 128 * i
            tile = np.full((128, TAIL_K), np.nan, np.float32)
            rows = min(128, ck - n)
            tile[:rows] = w2p[n:n + rows, j * TAIL_K:(j + 1) * TAIL_K]
            tiles.append(tile)
    return tiles


def _to_tiles(a):
    """(B, H, W, n) -> (B * tiles, 64, n), tiles and pixels in the kernel's order."""
    b, h, w, n = a.shape
    return a.reshape(b, h // 8, 8, w // 8, 8, n).transpose(0, 1, 3, 2, 4, 5).reshape(-1, 64, n)


def _from_tiles(t, b, h, w):
    n = t.shape[-1]
    return t.reshape(b, h // 8, w // 8, 8, 8, n).transpose(0, 1, 3, 2, 4, 5).reshape(b, h, w, n)


def _emulate(y, ln_w, ln_b, w1, b1, w2, b2, init, eps=1e-5, three=True, swap_ag=False):
    """The tile on every 8x8 tile of y (B, H, W, C) float32: LN2(y) staged
    [64][CK] (zero past C), per output group the hidden loop over the ring's
    tiles, the sums started from init(tiles) (N, 64, C). Returns the sums
    (B, H, W, C). three=False: one TF32 product; swap_ag: the slab's a and g
    rows taken the wrong way round (the planted faults)."""
    b, h, w, c = y.shape
    hid = w2.shape[1]
    pl = tail_f32_plan(c, hid)
    ck = pl["ck"]
    w1p, w2p = (t.numpy() for t in pack_mlp_weights(w1, w2, torch.float32))
    lnw, lnb = ln_w.float().numpy(), ln_b.float().numpy()
    b1f, b2f = b1.float().numpy(), b2.float().numpy()
    yt = _to_tiles(y.float().numpy())
    mu = yt.mean(-1, keepdims=True)
    rs = 1 / np.sqrt(((yt - mu) ** 2).mean(-1, keepdims=True) + eps)
    xs = np.zeros(yt.shape[:2] + (ck,), np.float32)
    xs[..., :c] = (yt - mu) * rs * lnw + lnb
    out = init(yt).astype(np.float32)
    a_cols, g_cols = (G_COLS, A_COLS) if swap_ag else (A_COLS, G_COLS)
    for n0, nk2 in pl["groups"]:
        width = min(TAIL_MAX_C, ck - n0)
        stream = iter(_stream(w1p, w2p, pl, n0, nk2))
        acc = np.zeros(yt.shape[:2] + (width,), np.float32)
        for j in range(pl["nch"]):
            hh = np.zeros(yt.shape[:2] + (128,), np.float32)
            for kt in range(pl["nk1"]):
                hh = _mma(hh, xs[..., kt * TAIL_K:(kt + 1) * TAIL_K], next(stream).T, three)
            units = j * TAIL_K + np.arange(TAIL_K)
            ok = units < hid
            ba = np.where(ok, b1f[np.minimum(units, hid - 1)], 0)
            bg = np.where(ok, b1f[hid + np.minimum(units, hid - 1)], 0)
            a, g = hh[..., a_cols] + ba, hh[..., g_cols] + bg
            gated = a * gelu_exact(torch.from_numpy(g)).numpy()
            for i in range(nk2):
                tile = next(stream)
                rows = min(128, ck - n0 - 128 * i)
                cols = slice(128 * i, 128 * i + rows)
                acc[..., cols] = _mma(acc[..., cols], gated, tile[:rows].T, three)
        assert next(stream, None) is None
        k = min(c, n0 + width) - n0
        out[..., n0:n0 + k] += acc[..., :k]
    return _from_tiles(out, b, h, w)


def _weights(c, hid, seed):
    r = _rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (r.standard_normal(s) * scale).astype(np.float32))
    return f, (1 + f(c, scale=0.1), f(c, scale=0.1), f(2 * hid, c, scale=c ** -0.5),
               f(2 * hid, scale=0.1), f(c, hid, scale=hid ** -0.5), f(c, scale=0.1))


def _k6(c, hid, residual, dp, **faults):
    """(emulated, plain) K6 on 2 images of 8x16 (4 tiles)."""
    f, wts = _weights(c, hid, 80 + c)
    x = f(2, 8, 16, c)
    scale = torch.tensor([1.25, 0.0]) if dp else None
    b2 = wts[5].numpy()
    br = _emulate(x, *wts, lambda yt: np.broadcast_to(b2, yt.shape), **faults)
    s = np.ones((2, 1, 1, 1), np.float32) if scale is None else scale.numpy()[:, None, None, None]
    got = br * s + (x.numpy() if residual else 0)
    return got, mlp_plain(x, *wts, residual=residual, dp_scale=scale).numpy()


def _apply(c, hid, fusion, **faults):
    """(emulated, plain) spectral apply with the tail: the front's output
    (spectral_apply_plain without the tail) through the emulated tile, its
    sums started from y + b2. fusion: the PromptFusion entry (x2 + LN +
    residual); else a shifted PGSSTB's gate and shortcut epilogue."""
    f, wts = _weights(c, hid, 90 + c)
    x = f(2, 8, 16, c)
    comb, wq, wd = f(2, c, c, scale=c ** -0.5), f(3 * c, c, 1, 1, scale=c ** -0.5), f(
        3 * c, 1, 3, 3, scale=1 / 3)
    if fusion:
        kw = dict(x2=f(2, 8, 16, c - c // 2), ln_w=1 + f(c, scale=0.1), ln_b=f(c, scale=0.1),
                  residual=True)
        x = x[..., :c // 2].contiguous()
    else:
        kw = dict(shift=4, gate=f(2, 1, 2, c, scale=0.5), shortcut=f(2, 8, 16, c))
    y = spectral_apply_plain(x, comb, wq, wd, **kw)
    b2 = wts[5].numpy()
    got = _emulate(y, *wts, lambda yt: yt + b2, **faults)
    return got, spectral_apply_plain(x, comb, wq, wd, mlp=wts, **kw).numpy()


def _rel(got, ref):
    return float(np.abs(got - ref).max()) / float(np.abs(ref).max())


def test_tf32_rounding_is_cvt_rna():
    """The emulated cvt.rna: 13 low bits off, ties away from zero in
    magnitude, on both signs; a TF32 value is its own rounding."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's unit in the last place at 1
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23, 1 + ulp], np.float32)
    np.testing.assert_array_equal(_tf32(x), [one + ulp, -(one + ulp), one, one + ulp])
    pi = np.array([np.pi], np.float32)
    big, small = _split(pi)
    assert _tf32(big) == big and _tf32(small) == small
    assert abs(float(big[0]) + float(small[0]) - float(pi[0])) < 2 ** -21


def test_tail_f32_flushed_sums_beat_chained():
    """Why each k8 step's products are flushed into float32 registers: on a
    64 x 1024 by 1024 x 64 product (fc2's depth at the remote-sensing
    preset's widest tail) the tensor cores' truncated sums chained over K
    drift past 2e-6 of the output's max-abs, flushed they stay below 1e-6
    (float32 FMA's own error is ~1e-6 here)."""
    r = _rng(5)
    a = r.standard_normal((64, 1024)).astype(np.float32)
    b = (r.standard_normal((1024, 64)) / 32).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    zero = np.zeros((64, 64), np.float32)
    err = [float(np.abs(_mma(zero, a, b, chained=ch) - ref).max() / np.abs(ref).max())
           for ch in (False, True)]
    assert err[0] < 1e-6 < 2e-6 < err[1], err


@pytest.mark.parametrize("c", sorted(PLANS))
def test_tail_f32_plan(c):
    """The plan mirror: ring stages and bytes per width, within the budget
    (one stage more would not be, below 4); the output groups cover CK in
    slices of at most 384 channels, their fc2 tiles 128 channels each."""
    pl = tail_f32_plan(c, 100)
    assert (pl["ws"], pl["bytes"]) == PLANS[c]
    assert pl["bytes"] <= TAIL_F32_BUDGET
    if pl["ws"] < 4:
        assert pl["bytes"] + TAIL_STAGE_F32 > TAIL_F32_BUDGET
    assert pl["ck"] % 64 == 0 and c <= pl["ck"] < c + 64 and pl["ld"] % 32 == 4
    starts = [n0 for n0, _ in pl["groups"]]
    assert starts == list(range(0, pl["ck"], TAIL_MAX_C))
    for n0, nk2 in pl["groups"]:
        assert (nk2 - 1) * 128 < min(TAIL_MAX_C, pl["ck"] - n0) <= nk2 * 128


@pytest.mark.parametrize("c,hid", WIDTHS)
@pytest.mark.parametrize("residual,dp", [(False, False), (True, True)])
def test_tail_f32_k6_emulation_matches_plain(c, hid, residual, dp):
    """K6 (the mlp kernel) emulated on 4 tiles, sums started from b2, then
    [x +] s_b (branch), against mlp_plain in float32 within 1e-5 of its
    max-abs (drop-path scales [1.25, 0.0])."""
    got, ref = _k6(c, hid, residual, dp)
    assert _rel(got, ref) <= TOL, _rel(got, ref)


@pytest.mark.parametrize("c,hid", WIDTHS)
@pytest.mark.parametrize("fusion", [False, True])
def test_tail_f32_apply_emulation_matches_plain(c, hid, fusion):
    """The spectral apply kernel's tail emulated after the front's epilogue
    (a shifted block's gate and shortcut; the PromptFusion x2 + LN +
    residual entry), sums started from y + b2, against spectral_apply_plain
    with the tail in float32 within 1e-5 of its max-abs."""
    got, ref = _apply(c, hid, fusion)
    assert _rel(got, ref) <= TOL, _rel(got, ref)


@pytest.mark.parametrize("fault", [dict(three=False), dict(swap_ag=True)],
                         ids=["one-tf32-product", "a-g-rows-swapped"])
@pytest.mark.parametrize("c,hid", [(64, 170), (400, 100)])
def test_tail_f32_emulation_sees_the_faults(fault, c, hid):
    """The check is not blind: one TF32 product instead of three (10-bit
    operands) and the slab's a and g rows swapped each break the 1e-5 bound,
    in K6 and in the apply kernel's tail."""
    for got, ref in (_k6(c, hid, True, True, **fault), _apply(c, hid, False, **fault)):
        assert _rel(got, ref) > TOL, _rel(got, ref)


def test_tail_f32_emulation_matches_pallas_interpret():
    """One tiny case (C 16, hid 42, residual, drop-path [1.25, 0.0]) of the
    emulated K6 in float32 against the JAX package's _mlp_fwd_call (the
    Pallas _mlp_kernel) run in interpret mode: 1e-4 of the output's max-abs
    (the Pallas GELU is a polynomial 1.5e-6 from erf)."""
    import jax.numpy as jnp

    from mp_hsir_tpu.ops.pallas_attention import _mlp_fwd_call

    c, hid = 16, 42
    f, (lw, lb, w1, b1, w2, b2) = _weights(c, hid, 96)
    x = f(2, 8, 16, c)
    dp = torch.tensor([1.25, 0.0])
    br = _emulate(x, lw, lb, w1, b1, w2, b2, lambda yt: np.broadcast_to(b2.numpy(), yt.shape))
    got = x.numpy() + br * dp.numpy()[:, None, None, None]
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    want = np.asarray(_mlp_fwd_call(j(x), j(lw), j(lb), j(w1.t().contiguous()), j(b1),
                                    j(w2.t().contiguous()), j(b2), j(dp), hidden=hid, eps=1e-5,
                                    residual=True, interpret=True), np.float32)
    assert _rel(got, want) <= 1e-4, _rel(got, want)
