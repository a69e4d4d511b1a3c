"""The float32 conv3 tile (K4's float32 instance: ``c3_tf32_chunk`` in
csrc/conv3.cu, 3xTF32 on m16n8k8) without a card: the plan mirror
``conv3_plan``, and the tile emulated in numpy from its own tile map
(``pack_weight``'s float32 slabs [Cout/64][Cin/8][9 taps][64 out][8 in];
per K chunk of 8 input channels the nine taps in order, each tap one k8
step whose A rows are the zero-padded halo shifted by the tap; every
fragment split into TF32 big and small halves, the three products summed
on the tensor cores toward zero, then added in float32; then the mode's
writeback) against ``conv3_plain`` in float32 at every conv3 shape of the
two presets' forwards on a small map, all four modes; two planted faults
the check must catch; one case against the JAX package's ``_conv3_raw_call``
in interpret mode. The kernel itself is held against the plain version on
the card by tests/test_torch_cuda.py and chip_smoke.py. Imports JAX only in
the test that compares with it."""

import numpy as np
import pytest
import torch

from mp_hsir_tpu_torch.ops.basic import pixel_shuffle, pixel_unshuffle
from mp_hsir_tpu_torch.ops.kernels.conv3 import (
    CHUNK_K_F32, TILE_N, conv3_plain, conv3_plan, pack_weight,
)
from tf32_emulation import mma_step
from torch_port_inputs import normal as _n, rng as _rng
import torch_threads  # noqa: E402,F401  (one compute thread per process)

# (Cin, Cout, mode): every conv3 call of the flagship's and the
# remote-sensing preset's forwards (Cin 31: rows not 16-byte multiples, the
# halo staged by element; Cin 100: a ragged last chunk; Cout 31 and 100: a
# ragged last tile)
SHAPES = [(31, 64, "plain"), (64, 32, "down"), (128, 64, "down"), (256, 512, "up"),
          (128, 256, "up"), (128, 128, "plain"), (64, 64, "plain"), (128, 31, "res"),
          (100, 96, "plain"), (96, 48, "down"), (192, 96, "down"), (384, 768, "up"),
          (192, 384, "up"), (192, 192, "plain"), (96, 96, "plain"), (192, 100, "res")]
# of the output's max-abs: against the plain version on the CPU, whose own
# float32 convolution lies up to 3.1e-6 from the exact (float64) one at Cin
# 384; against the exact one, the tile's own error (0.8e-6 there)
TOL, TOL_EXACT = 1e-5, 2e-6


def _inputs(cin, cout, seed, b=1, h=8, w=16):
    r = _rng(seed)
    x = torch.from_numpy(_n(r, (b, h, w, cin)))
    wt = torch.from_numpy(_n(r, (cout, cin, 3, 3), (9 * cin) ** -0.5))
    res = torch.from_numpy(_n(r, (b, h, w, cout)))
    return x, wt, res


def _emulate(x, w, mode, res=None, three=True, halo_shift=0):
    """The tile on x (B, H, W, Cin) float32: the float32 sums of every output
    pixel and channel, K chunk by K chunk (8 channels, zero past Cin), tap by
    tap (3 dy + dx), one 3xTF32 k8 step each, then the writeback. halo_shift
    1: the halo staged one pixel to the right (a planted fault)."""
    b, h, wd, cin = x.shape
    cout = w.shape[0]
    wk = pack_weight(w, torch.float32).numpy()  # (nt, nc, 9, 64, 8)
    nt, nc = wk.shape[:2]
    xp = np.zeros((b, h + 2, wd + 2 + halo_shift, nc * CHUNK_K_F32), np.float32)
    xp[:, 1:h + 1, 1:wd + 1, :cin] = x.numpy()
    acc = np.zeros((b * h * wd, nt * TILE_N), np.float32)
    for c in range(nc):
        ks = slice(CHUNK_K_F32 * c, CHUNK_K_F32 * (c + 1))
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            a = xp[:, dy:dy + h, dx + halo_shift:dx + halo_shift + wd, ks].reshape(-1, CHUNK_K_F32)
            bm = wk[:, c, tap].transpose(2, 0, 1).reshape(CHUNK_K_F32, nt * TILE_N)  # [k][n]
            acc = mma_step(acc, a, bm, three)
    y = torch.from_numpy(acc[:, :cout].reshape(b, h, wd, cout))
    if mode == "res":
        y = y + res
    elif mode == "down":
        y = pixel_unshuffle(y, 2)
    elif mode == "up":
        y = pixel_shuffle(y, 2)
    return y.numpy()


def _rel(got, ref):
    return float(np.abs(got - ref).max()) / float(np.abs(ref).max())


def _exact(x, w, mode, res):
    """The convolution and writeback in float64."""
    y = torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2), w.double(), padding=1)
    y = y.permute(0, 2, 3, 1)
    if mode == "res":
        return (y + res.double()).numpy()
    return {"plain": y, "down": pixel_unshuffle(y, 2), "up": pixel_shuffle(y, 2)}[mode].numpy()


def _case(cin, cout, mode, **faults):
    """(emulated, plain, exact) on one 8x16 map."""
    x, w, res = _inputs(cin, cout, 60 + cin + cout)
    r = res if mode == "res" else None
    return (_emulate(x, w, mode, r, **faults), conv3_plain(x, w, mode, r).numpy(),
            _exact(x, w, mode, r))


def test_conv3_f32_plan():
    """One plan per compute type, whatever the shape: three stages of
    33,984 B (the float32 halo [324][12] and slab [9][64][8]; the bf16 halo
    [324][24] and slab [9][16][64]), within the limit with room for a second
    block per SM."""
    assert conv3_plan(torch.float32) == conv3_plan(torch.bfloat16) == 101952
    assert 2 * (conv3_plan(torch.float32) + 1024) <= 233472  # the SM's 228 KB


@pytest.mark.parametrize("cin,cout,mode", SHAPES)
def test_conv3_f32_emulation_matches_plain(cin, cout, mode):
    """The emulated tile against conv3_plain in float32 within 1e-5 of the
    output's max-abs, and against the exact convolution within 2e-6, on one
    8x16 map (half a 16x16 tile: the masked rows)."""
    got, ref, exact = _case(cin, cout, mode)
    assert got.shape == ref.shape
    assert _rel(got, ref) <= TOL, _rel(got, ref)
    assert _rel(got, exact) <= TOL_EXACT, _rel(got, exact)


@pytest.mark.parametrize("fault", [dict(three=False), dict(halo_shift=1)],
                         ids=["one-tf32-product", "halo-off-by-one-tap"])
@pytest.mark.parametrize("cin,cout,mode", [(31, 64, "plain"), (192, 100, "res")])
def test_conv3_f32_emulation_sees_the_faults(fault, cin, cout, mode):
    """The check is not blind: one TF32 product instead of three (10-bit
    operands) and the halo staged one pixel off each break the bound."""
    got, ref, _ = _case(cin, cout, mode, **fault)
    assert _rel(got, ref) > TOL, _rel(got, ref)


def test_conv3_f32_emulation_matches_pallas_interpret():
    """One case (Cin 31, Cout 64 down: the element-staged halo, the
    PixelUnshuffle writeback) of the emulated tile against the JAX package's
    _conv3_raw_call (the Pallas _conv3_down_kernel) run in interpret mode in
    float32: 1e-5 of the output's max-abs."""
    import jax.numpy as jnp

    from mp_hsir_tpu.ops.pallas_attention import _conv3_raw_call

    x, w, _ = _inputs(31, 64, 7, h=16, w=16)
    got = _emulate(x, w, "down")
    hwio = jnp.asarray(w.permute(2, 3, 1, 0).numpy())
    want = np.asarray(_conv3_raw_call(jnp.asarray(x.numpy()), hwio, interpret=True, mode="down"))
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5, _rel(got, want)
