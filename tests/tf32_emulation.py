"""The 3xTF32 tensor-core products of the float32 tiles (common.cuh:
``split_tf32``, ``mma_3xtf32``), emulated in numpy for the CPU tests of
the float32 tail, conv3 and window tiles (tests/test_torch_tail_f32.py,
tests/test_torch_conv3_f32.py, tests/test_torch_window_f32.py)."""

import numpy as np


def tf32(a):
    """cvt.rna.tf32.f32: the 13 low mantissa bits rounded off, ties away
    from zero (the carry runs into the exponent as the hardware's does)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a):
    big = tf32(a)
    return big, tf32(a - big)


def trunc(x):
    """float64 -> float32 rounded toward zero: how the tensor cores round
    the float32 sum of a mma.sync (its products exact)."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _terms(a, b, three):
    ab, as_ = split(a)
    bb, bs = split(b)
    return [(as_, bb), (ab, bs), (ab, bb)] if three else [(ab, bb)]


def mma_step(acc, a, b, three=True):
    """acc (.., M, N) float32 + one k8 step a (.., M, 8) x b (.., 8, N) as
    mma_3xtf32 takes it: the three TF32 products (small big, big small, big
    big) summed from zero on the tensor cores (rounded toward zero), then
    added to acc in float32. three=False: one TF32 product (a planted
    fault)."""
    t = np.zeros(np.broadcast_shapes(acc.shape, a.shape[:-1] + b.shape[-1:]), np.float32)
    for x, y in _terms(a, b, three):
        t = trunc(t + x.astype(np.float64) @ y.astype(np.float64))
    return acc + t


def mma(acc, a, b, three=True, chained=False):
    """acc (.., M, N) float32 += a (.., M, K) x b (.., K, N), k8 step by k8
    step (mma_step). chained: the products summed into acc on the tensor
    cores across all of K (what the per-step flush avoids)."""
    if not chained:
        for k in range(0, a.shape[-1], 8):
            acc = mma_step(acc, a[..., k:k + 8], b[..., k:k + 8, :], three)
        return acc
    terms = _terms(a, b, three)
    for k in range(0, a.shape[-1], 8):
        for x, y in terms:
            acc = trunc(acc + x[..., k:k + 8].astype(np.float64)
                        @ y[..., k:k + 8, :].astype(np.float64))
    return acc
