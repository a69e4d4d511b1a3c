"""The float32 window-attention tile (K1's float32 instance,
``window_f32_kernel`` in csrc/window_attention.cu: 3xTF32 on m16n8k8)
without a card: the plan mirror ``window_f32_plan`` at every preset width,
and the tile emulated in numpy from its own tile map (per window of the
rolled frame, LN in float32 on rows zero-padded to the 64-deep K chunk; q,
k, v from ``pack_qkv_weight``'s float32 pack padded to the head width; S =
q k^T and O = P V with each k8 step's columns taken in the accumulators'
order 0, 2, 4, 6, 1, 3, 5, 7, k and v read in the same order; the scale,
the relative bias and the -100 mask, a max-subtracted softmax; O packed at
the head width against ``pack_proj_weight``; the window means summed over
the rows in order; every product split into TF32 big and small halves,
the three products summed on the tensor cores toward zero, then added in
float32) against ``window_attention_plain`` in float32 at every (C, heads)
of the presets, shifted (with the region labels) and not; two planted
faults the check must catch; one case against the JAX package's
``_win_raw_call`` in interpret mode. The kernel itself is held against the
plain version on the card by tests/test_torch_cuda.py and chip_smoke.py.
Imports JAX only in the test that compares with it."""

import numpy as np
import pytest
import torch

from mp_hsir_tpu_torch.ops.kernels.window_attention import (
    K_CHUNK, head_width, pack_proj_weight, pack_qkv_weight, window_attention_plain,
    window_f32_plan,
)
from mp_hsir_tpu_torch.ops.window import shifted_region_map
from tf32_emulation import mma
from torch_port_inputs import rng as _rng, tensor as _t, window_inputs as _window_inputs
import torch_threads  # noqa: E402,F401  (one compute thread per process)

# (C, heads) of every window call of the presets (dh 32, 64, 48, 96) and
# C = 36 and 27 (dh 18 and 9, padded to 32 and 16; C = 27 staged by
# element); C = 384 splits its heads over a two-block cluster
WIDTHS = [(64, 2), (128, 4), (256, 8), (128, 2), (96, 2), (192, 4), (384, 8), (192, 2), (36, 2),
          (27, 3)]
# (padded head width, ring stages, blocks per window, dynamic bytes)
PLANS = {(64, 2): (32, 3, 1, 80384), (128, 4): (32, 3, 1, 113152),
         (256, 8): (32, 3, 1, 178688), (128, 2): (64, 2, 1, 138240),
         (96, 2): (48, 2, 1, 121344), (192, 4): (48, 2, 1, 154112),
         (384, 8): (48, 2, 2, 203264), (192, 2): (96, 2, 1, 204800),
         (36, 2): (32, 3, 1, 80384), (27, 3): (16, 6, 1, 72192)}
LIMIT = 232448  # the H100's shared memory per block (opt-in)
STATIC = 256    # the kernel's static shared memory: the window's 64 labels
EPS = 1e-5
TOL = 2e-6  # of each output's max-abs: float32 both sides, sums in other orders
# a k8 step's columns in the order the accumulators hold them
PERM8 = np.array([0, 2, 4, 6, 1, 3, 5, 7])


def _round_k(n):
    return -(-n // K_CHUNK) * K_CHUNK


def _windows(a):
    """(B, H, W, n) -> (B H/8 W/8, 64, n), windows in row-major order."""
    b, h, w, n = a.shape
    return a.reshape(b, h // 8, 8, w // 8, 8, n).transpose(0, 1, 3, 2, 4, 5).reshape(-1, 64, n)


def _unwindows(t, b, h, w):
    n = t.shape[-1]
    return t.reshape(b, h // 8, w // 8, 8, 8, n).transpose(0, 1, 3, 2, 4, 5).reshape(b, h, w, n)


def _order(n):
    """The k order of n columns taken k8 step by k8 step as the tile takes them."""
    return (8 * np.arange(n // 8)[:, None] + PERM8).reshape(-1)


def _emulate(x, ln_w, ln_b, wqkv, bqkv, rel_bias, wp, bp, heads, shift, three=True,
             unpermuted_v=False):
    """The tile on x (B, H, W, C) float32 (unrolled; torch-Linear weights):
    (out in the rolled frame, pooled). three=False: one TF32 product;
    unpermuted_v: P in the accumulators' key order against v's rows in
    their own order (the planted faults)."""
    b, h, w, c = x.shape
    dh = c // heads
    dhp, kx = head_width(dh), _round_k(c)
    ko = _round_k(heads * dhp)
    xr = np.roll(x.numpy(), (-shift, -shift), axis=(1, 2)) if shift else x.numpy()
    xt = _windows(xr)
    n = xt.shape[0]
    mu = xt.mean(-1, keepdims=True)
    rs = 1 / np.sqrt(((xt - mu) ** 2).mean(-1, keepdims=True) + np.float32(EPS))
    xs = np.zeros((n, 64, kx), np.float32)
    xs[..., :c] = (xt - mu) * rs * ln_w.numpy() + ln_b.numpy()
    wq = pack_qkv_weight(wqkv, heads, torch.float32).numpy()  # (nH, 3, DHP, kx)
    qkv = mma(np.zeros((n, 64, heads * 3 * dhp), np.float32), xs,
              wq.reshape(-1, kx).T, three).reshape(n, 64, heads, 3, dhp)
    bq = np.zeros((3, heads, dhp), np.float32)
    bq[..., :dh] = bqkv.numpy().reshape(3, heads, dh)
    q, k, v = (qkv[:, :, :, s].transpose(0, 2, 1, 3) + bq[s][:, None] for s in range(3))
    od = _order(dhp)
    s_ = mma(np.zeros((n, heads, 64, 64), np.float32), q[..., od],
             k[..., od].swapaxes(-1, -2), three)
    s_ = s_ * np.float32(1 / np.sqrt(dh)) + rel_bias.numpy()
    if shift:
        lab = _windows(shifted_region_map(h, w, 8, shift)[None, :, :, None].astype(np.float32))
        lab = np.tile(lab[..., 0], (b, 1))
        s_ = np.where(lab[:, None, :, None] != lab[:, None, None, :], s_ - np.float32(100), s_)
    e = np.exp(s_ - s_.max(-1, keepdims=True))
    p = e * (1 / e.sum(-1, keepdims=True))
    ok = _order(64)
    o = mma(np.zeros((n, heads, 64, dhp), np.float32), p[..., ok],
            v[..., np.arange(64) if unpermuted_v else ok, :], three)
    op = np.zeros((n, 64, ko), np.float32)
    op[..., :heads * dhp] = o.transpose(0, 2, 1, 3).reshape(n, 64, -1)
    wpk = pack_proj_weight(wp, heads, torch.float32).numpy()  # (nH, DHP, ko)
    y = mma(np.zeros((n, 64, heads * dhp), np.float32), op, wpk.reshape(-1, ko).T, three)
    y = y.reshape(n, 64, heads, dhp)[..., :dh].reshape(n, 64, c) + bp.numpy()
    pooled = np.zeros((n, c), np.float32)
    for i in range(64):
        pooled = pooled + y[:, i]
    pooled = pooled * np.float32(1 / 64)
    return _unwindows(y, b, h, w), pooled.reshape(b, h // 8, w // 8, c)


def _weights(c, heads, seed, h=16, w=16):
    d = _window_inputs(seed, c, heads, h, w)
    return (_t(d["x"]), _t(d["ln_w"]), _t(d["ln_b"]), _t(d["wqkv"]).t().contiguous(),
            _t(d["bqkv"]), _t(d["rel_bias"]), _t(d["wp"]).t().contiguous(), _t(d["bp"]))


def _rel(got, ref):
    return max(float(np.abs(g - r).max()) / float(np.abs(r).max()) for g, r in zip(got, ref))


def _case(c, heads, shift, **faults):
    args = _weights(c, heads, 70 + c + heads)
    got = _emulate(*args, heads, shift, **faults)
    ref = tuple(t.numpy() for t in window_attention_plain(*args, heads, shift=shift))
    return got, ref


@pytest.mark.parametrize("c,heads", WIDTHS)
def test_window_f32_plan(c, heads):
    """The plan mirror at every width: head width, ring stages, blocks per
    window and bytes as pinned; within the device's limit with the static
    labels; the split plan taken only where the one-block plan does not
    fit."""
    pl = window_f32_plan(c, heads, LIMIT - STATIC)
    assert (pl["dhp"], pl["stages"], pl["blocks"], pl["bytes"]) == PLANS[(c, heads)]
    assert pl["bytes"] + STATIC <= LIMIT
    assert (pl["blocks"] == 2) == (pl["one"] + STATIC > LIMIT)
    assert pl["ldx"] % 32 == 4 and pl["dhp"] % 16 == 0


def test_window_f32_plan_without_a_fit():
    """A width whose plan fits neither way (C 256 with 2 heads of 128) has
    none: the wrapper's plan check raises there."""
    pl = window_f32_plan(256, 2, LIMIT - STATIC)
    assert pl["blocks"] == 0 and pl["bytes"] + STATIC > LIMIT


@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("c,heads", WIDTHS)
def test_window_f32_emulation_matches_plain(c, heads, shift):
    """The emulated tile against window_attention_plain in float32 on one
    16x16 map (4 windows), unshifted and shifted with the region labels:
    y and the window means within 2e-6 of each one's max-abs."""
    got, ref = _case(c, heads, shift)
    assert all(g.shape == r.shape for g, r in zip(got, ref))
    assert _rel(got, ref) <= TOL, _rel(got, ref)


@pytest.mark.parametrize("fault", [dict(three=False), dict(unpermuted_v=True)],
                         ids=["one-tf32-product", "v-rows-unpermuted"])
@pytest.mark.parametrize("c,heads", [(64, 2), (384, 8)])
def test_window_f32_emulation_sees_the_faults(fault, c, heads):
    """The check is not blind: one TF32 product instead of three (10-bit
    operands) and P's permuted key order against v's rows in their own
    order each break the bound."""
    got, ref = _case(c, heads, 4, **fault)
    assert _rel(got, ref) > TOL, _rel(got, ref)


def test_window_f32_emulation_matches_pallas_interpret():
    """One shifted case (C 32, 2 heads of 16, a 16x32 map) of the emulated
    tile against the JAX package's _win_raw_call (the Pallas _nhwc_kernel,
    reached through fused_ln_window_attention_nhwc's in-kernel roll) run in
    interpret mode in float32: 1e-4 of each output's max-abs (the Pallas
    kernel folds the scale into the weights and runs exp2 without the
    max-subtract)."""
    import jax.numpy as jnp

    from mp_hsir_tpu.ops import pallas_attention as PA

    c, heads, h, w = 32, 2, 16, 32
    d = _window_inputs(9, c, heads, h, w)
    want = PA.fused_ln_window_attention_nhwc(
        jnp.asarray(d["x"]), jnp.asarray(d["ln_w"]), jnp.asarray(d["ln_b"]),
        jnp.asarray(d["wqkv"]), jnp.asarray(d["bqkv"]), jnp.asarray(d["rel_bias"]),
        jnp.asarray(d["wp"]), jnp.asarray(d["bp"]), jnp.asarray(shifted_region_map(h, w, 8, 4)),
        heads, shift_in=True, interpret=True)
    got = _emulate(_t(d["x"]), _t(d["ln_w"]), _t(d["ln_b"]), _t(d["wqkv"]).t().contiguous(),
                   _t(d["bqkv"]), _t(d["rel_bias"]), _t(d["wp"]).t().contiguous(), _t(d["bp"]),
                   heads, 4)
    assert _rel(got, tuple(np.asarray(t, np.float32) for t in want[:2])) <= 1e-4
