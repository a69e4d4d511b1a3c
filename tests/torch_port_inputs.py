"""Numpy-seeded inputs shared by the PyTorch port's kernel tests
(tests/test_torch_kernels.py on the CPU, tests/test_torch_cuda.py on the
card). Imports no JAX."""

import numpy as np
import torch


def rng(seed):
    return np.random.default_rng(seed)


def uniform(r, shape, fan_in):
    """torch's default init range U(+-1/sqrt(fan_in))."""
    b = 1.0 / np.sqrt(fan_in)
    return r.uniform(-b, b, shape).astype(np.float32)


def normal(r, shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def tensor(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def window_inputs(seed, c, heads, h, w):
    """Window-attention operands in the JAX layouts ((in, out) weights), plus
    the following spectral attention's qkv / dwconv weights."""
    r = rng(seed)
    return dict(
        x=normal(r, (1, h, w, c)), ln_w=1 + normal(r, (c,), 0.1), ln_b=normal(r, (c,), 0.1),
        wqkv=uniform(r, (c, 3 * c), c), bqkv=uniform(r, (3 * c,), c),
        rel_bias=normal(r, (heads, 64, 64), 0.02), wp=uniform(r, (c, c), c),
        bp=uniform(r, (c,), c), wqkv_sp=uniform(r, (c, 3 * c), c), wdw_sp=uniform(r, (9, 3 * c), 9))


def spectral_weights(r, c, heads):
    """SpectralAttention weights in the JAX layouts (HWIO convs)."""
    return dict(wqkv=uniform(r, (1, 1, c, 3 * c), c), wdw=uniform(r, (3, 3, 1, 3 * c), 9),
                temp=1 + normal(r, (heads, 1, 1), 0.2), wout=uniform(r, (1, 1, c, c), c))


def oihw(w):
    """HWIO numpy conv weight -> OIHW torch tensor."""
    return tensor(np.transpose(w, (3, 2, 0, 1)))
