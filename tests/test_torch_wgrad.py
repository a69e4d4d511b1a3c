"""The weight product of the backward kernels (``wgrad`` in
``ops/kernels/_grad.py``; bf16 ``wgrad_tc_kernel`` in csrc/grad.cu) without a
card: ``wgrad_plain`` against JAX's einsum on the same bf16 inputs, the CPU
route, the part plan ``wgrad_plan``, and the tensor-core kernel emulated in
numpy from its own tile map (the copy width chosen per operand, the zero
fill past ragged widths and past each part's end, the ring of stages over
pixels, ldmatrix.trans fragments, the warps' sub-tiles in the epilogue, the
partials summed in part order) against ``wgrad_plain``, with planted faults
it must catch. The kernel itself is held against ``wgrad_plain`` on the card
by tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp_hsir_tpu_torch.ops.kernels import _route
from mp_hsir_tpu_torch.ops.kernels._grad import (
    WGRAD_BLOCKS, WGRAD_DEPTH, WGRAD_MIN_PIX, WGRAD_RING, WGRAD_TILE, wgrad, wgrad_plain,
    wgrad_plan,
)
from torch_port_inputs import rng as _rng
import torch_threads  # noqa: E402,F401  (one compute thread per process)

# float32 sums of the same exact bf16 products in other orders, P <= 2248
EMU_TOL = 1e-5
# (M, N): the presets' ragged rows (hid 170: 4-byte copies of A; 255 and
# 1021: element loads; 2 hid 340 and 510: 8- and 4-byte copies of B) beside
# C = 64, 96, 384, and the test widths C = 36 and 27 (3C = 108, 81)
EMU_WIDTHS = [(64, 340), (170, 64), (255, 96), (96, 510), (1021, 384), (36, 108), (27, 81)]
EMU_P = 2248  # 70.25 ring stages, 17.6 rings: P is no multiple of either


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)


def _operands(nb, p, m, n, seed=0):
    r = _rng(200 + m + n + nb + seed)
    return (_bf16(r.standard_normal((nb, p, m))), _bf16(r.standard_normal((nb, p, n))))


def copy_elems(width: int, base: int) -> int:
    """wgrad_copy_elems (grad.cu): elements per copy of an operand with rows
    of ``width`` bf16 from byte address ``base``."""
    for v in (8, 4, 2):
        if width % v == 0 and base % (2 * v) == 0:
            return v
    return 1


def _stage(flat, width, p0, p_end, c0, v, base):
    """The WGRAD_DEPTH x WGRAD_TILE tile wg_issue stages from an operand
    (``flat``: its rows in order, then NaN past the end, at byte address
    ``base``): units of v elements (v = 1: element loads), a unit zero where
    its pixel is at or past p_end or its first column at or past the width.
    A copy from an address that is not a multiple of its size is the card's
    misaligned-address fault: raised here."""
    rows = p0 + np.arange(WGRAD_DEPTH)[:, None]
    starts = c0 + np.arange(0, WGRAD_TILE, v)[None, :]
    ok = (rows < p_end) & (starts < width)
    if v > 1 and ((base + 2 * (rows * width + starts))[ok] % (2 * v)).any():
        raise AssertionError(f"misaligned {2 * v}-byte copy")
    idx = (rows * width + starts)[..., None] + np.arange(v)
    vals = flat[np.where(ok[..., None], np.minimum(idx, len(flat) - 1), 0)]
    return np.where(ok[..., None], vals, 0.0).reshape(WGRAD_DEPTH, WGRAD_TILE)


def emulate(a, b, fault=None, base=(0, 0)):
    """wgrad_tc_kernel in numpy: per (image, part, tile) block the ring of
    WGRAD_RING stages filled ahead (slot = step % ring), both operands read
    as [k][m] / [k][n] tiles transposed into fragments 16 pixels deep,
    float32 sums; the warps' 64x32 sub-tiles (2 x 4, the live rows on warps
    0-3 where a tile has at most 64) write the partial, which starts as NaN;
    then the partials added in part order. ``fault``: "transpose" (A's
    [k][m] tile read as [m][k]), "part" (each part's range starts one pixel
    tile late), "width" (16-byte copies whatever the row width)."""
    a32, b32 = a.float().numpy(), b.float().numpy()
    nb, p, m = a32.shape
    n = b32.shape[-1]
    n_parts, chunk = wgrad_plan(nb, p, m, n)
    va, vb = copy_elems(m, base[0]), copy_elems(n, base[1])
    if fault == "width":
        va = vb = 8
    parts = np.full((nb, n_parts, m, n), np.nan, np.float32)
    pad = np.full(WGRAD_TILE * 8, np.nan, np.float32)
    for bi in range(nb):
        fa, fb = np.concatenate([a32[bi].ravel(), pad]), np.concatenate([b32[bi].ravel(), pad])
        for part in range(n_parts):
            p_begin = min(p, part * chunk)
            p_end = min(p, p_begin + chunk)
            if fault == "part":
                p_begin = min(p_end, p_begin + WGRAD_DEPTH)
            steps = -(-(p_end - p_begin) // WGRAD_DEPTH)
            for m0 in range(0, m, WGRAD_TILE):
                for n0 in range(0, n, WGRAD_TILE):
                    ring = np.full((2, WGRAD_RING, WGRAD_DEPTH, WGRAD_TILE + 8), np.nan, np.float32)

                    def issue(step):
                        p0, slot = p_begin + step * WGRAD_DEPTH, step % WGRAD_RING
                        ring[0, slot, :, :WGRAD_TILE] = _stage(fa, m, p0, p_end, m0, va,
                                                               base[0] + 2 * bi * p * m)
                        ring[1, slot, :, :WGRAD_TILE] = _stage(fb, n, p0, p_end, n0, vb,
                                                               base[1] + 2 * bi * p * n)

                    for s in range(min(WGRAD_RING - 1, steps)):
                        issue(s)
                    acc = np.zeros((WGRAD_TILE, WGRAD_TILE), np.float32)
                    for step in range(steps):
                        if step + WGRAD_RING - 1 < steps:
                            issue(step + WGRAD_RING - 1)
                        xa, xb = ring[0, step % WGRAD_RING], ring[1, step % WGRAD_RING]
                        for kk in range(0, WGRAD_DEPTH, 16):
                            at = xa[kk:kk + 16, :WGRAD_TILE]  # [k][m]
                            if fault == "transpose":
                                fa16 = np.concatenate([at[:, j:j + 16]
                                                       for j in range(0, WGRAD_TILE, 16)])
                            else:
                                fa16 = at.T
                            acc += fa16 @ xb[kk:kk + 16, :WGRAD_TILE]
                    low = m - m0 <= 64
                    for warp in range(8):
                        wm, wn = (warp >> 2, warp & 3) if low else (warp & 1, warp >> 1)
                        rm, cn = m0 + wm * 64, n0 + wn * 32
                        for r0 in range(rm, min(rm + 64, m), 16):
                            for c0 in range(cn, min(cn + 32, n), 8):
                                r1, c1 = min(r0 + 16, m), min(c0 + 8, n)
                                parts[bi, part, r0:r1, c0:c1] = acc[r0 - m0:r1 - m0,
                                                                    c0 - n0:c1 - n0]
    out = parts[:, 0]
    for i in range(1, n_parts):
        out = out + parts[:, i]
    return out


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("nb,p,m,n", [(1, 300, 64, 340), (2, 177, 27, 81), (3, 96, 170, 64)])
def test_wgrad_plain_matches_jax(nb, p, m, n):
    """wgrad_plain against JAX's einsum with float32 products and sums
    (preferred_element_type) on the same bf16 inputs: float32 sums of exact
    products in other orders, within 1e-5 of the max-abs."""
    a, b = _operands(nb, p, m, n)
    ref = jnp.einsum("bpm,bpn->bmn", jnp.asarray(a.float().numpy(), jnp.bfloat16),
                     jnp.asarray(b.float().numpy(), jnp.bfloat16),
                     preferred_element_type=jnp.float32)
    got = wgrad_plain(a, b)
    assert got.dtype == torch.float32 and tuple(got.shape) == (nb, m, n)
    assert _rel_err(got.numpy(), np.asarray(ref)) <= 1e-5


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_wgrad_cpu_route_is_plain(dt):
    """On CPU tensors wgrad is wgrad_plain, for 3-D and 2-D operands: bitwise
    the same result and no launch counted."""
    a, b = (t.to(dt) for t in _operands(2, 200, 36, 108))
    _route.reset_counters()
    assert torch.equal(wgrad(a, b), wgrad_plain(a, b))
    got = wgrad(a[0], b[0])
    assert tuple(got.shape) == (36, 108) and torch.equal(got, wgrad_plain(a[0], b[0]))
    assert _route.COUNTERS["wgrad"].launches == 0 and _route.ROUTE.plain_cuda_calls == 0


@pytest.mark.parametrize("m,n", EMU_WIDTHS)
def test_wgrad_tile_emulation_matches_plain(m, n):
    """The kernel's tile map in numpy against wgrad_plain at every ragged
    width of the presets and the test widths, P = 2248 (two parts of 1152
    and 1096 pixels, the last stage of each part short)."""
    a, b = _operands(1, EMU_P, m, n)
    assert wgrad_plan(1, EMU_P, m, n)[0] == 2
    got = emulate(a, b)
    assert np.isfinite(got).all()
    assert _rel_err(got, wgrad_plain(a, b).numpy()) <= EMU_TOL


@pytest.mark.parametrize("nb,p,m,n,base", [(2, 1100, 255, 96, (0, 0)), (32, 100, 96, 96, (0, 0)),
                                           (1, 1100, 64, 340, (2, 8)),
                                           (1, 1100, 128, 680, (4, 2))])
def test_wgrad_tile_emulation_batches_and_bases(nb, p, m, n, base):
    """The tile map with several images (one part each: dcomb's shape), and
    with operands whose base address allows only narrower copies (2 bytes
    past 16: element loads; 4 bytes: 4-byte copies; 8 bytes: 8-byte copies)."""
    a, b = _operands(nb, p, m, n)
    got = emulate(a, b, base=base)
    assert np.isfinite(got).all()
    assert _rel_err(got, wgrad_plain(a, b).numpy()) <= EMU_TOL


@pytest.mark.parametrize("fault", ["transpose", "part", "width"])
@pytest.mark.parametrize("m,n", [(64, 340), (255, 96)])
def test_wgrad_emulation_catches_faults(fault, m, n):
    """The emulation's check is not blind: A's [k][m] tile read as [m][k] and
    a part range one pixel tile late each break the bound; 16-byte copies of
    rows that are not whole 16-byte vectors are misaligned."""
    a, b = _operands(1, EMU_P, m, n)
    if fault == "width":
        with pytest.raises(AssertionError, match="misaligned 16-byte copy"):
            emulate(a, b, fault=fault)
        return
    got = emulate(a, b, fault=fault)
    assert _rel_err(got, wgrad_plain(a, b).numpy()) > 100 * EMU_TOL


# (nb, P) of the presets' wgrad calls at batch 32 of 64x64 patches: per level
# P = 32 S^2 (S = 64, 32, 16), and dcomb's 32 images of S^2 pixels
PLAN_SHAPES = [(1, 131072), (1, 32768), (1, 8192), (32, 4096), (32, 1024), (32, 256)]
PLAN_WIDTHS = [(64, 340), (170, 64), (128, 680), (256, 1360), (96, 510), (255, 96),
               (384, 2042), (1021, 384), (64, 64), (384, 384)]


@pytest.mark.parametrize("nb,p", PLAN_SHAPES)
def test_wgrad_plan_covers_pixels_and_fills_the_card(nb, p):
    """wgrad_plan at the presets' shapes: the parts are WGRAD_DEPTH-aligned,
    cover [0, P) with none empty, hold at least WGRAD_MIN_PIX pixels where
    there is more than one, and give WGRAD_BLOCKS blocks or more unless the
    pixel floor caps them; with one part the kernel writes out directly."""
    for m, n in PLAN_WIDTHS:
        n_parts, chunk = wgrad_plan(nb, p, m, n)
        assert chunk % WGRAD_DEPTH == 0 and (n_parts - 1) * chunk < p <= n_parts * chunk
        tiles = nb * -(-m // WGRAD_TILE) * -(-n // WGRAD_TILE)
        if n_parts > 1:
            assert p // n_parts >= WGRAD_MIN_PIX
        assert tiles * n_parts >= WGRAD_BLOCKS or n_parts == max(1, p // WGRAD_MIN_PIX)
        assert wgrad_plan(nb, p, m, n) == (n_parts, chunk)  # a pure function of the shape
    assert wgrad_plan(32, 256, 384, 384)[0] == 1
    assert wgrad_plan(1, 131072, 64, 340, bf16=False) == (86, 1536)  # the float32 plan as before
