"""Window multi-head self-attention over window tokens (no LayerNorm): qkv
with bias, per-head softmax(q k^T / sqrt(dh) + relative-position bias) with
scores between tokens of different shift regions knocked out to -inf, the
heads concatenated, then the output projection with bias.

Kernel: ``mp_window_msa`` in ``csrc/window_attention.cu`` (replaces the TPU
kernel ``_kernel``, ``mp_hsir_tpu/ops/pallas_attention.py:40``, reached
through ``fused_window_attention``, ``:2339``; it shares the window
kernel's per-head device code). Plain version: :func:`window_msa_plain`, the
same arithmetic in PyTorch. There is no backward, as in the JAX package
(its Pallas call has no VJP): a backward through it raises.

Layouts: windows (NW, 64, C); wqkv (3C, C) and wp (C, C) as torch Linear
weights (the bf16 kernel streams them as the window kernel's head-major
packs, float32 as [in][out] copies); bqkv (3C,), bp (C,) and rel_bias
(nH, 64, 64) are used in float32; labels (nW_pattern, 64) int region labels,
tiled over the windows (NW % nW_pattern == 0), or None.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from mp_hsir_tpu_torch.ops.kernels import _build
from mp_hsir_tpu_torch.ops.kernels._route import (
    ROUTE, counter, dtype_code, f32, kernel_weight, stream_ptr,
)
from mp_hsir_tpu_torch.ops.kernels.window_attention import pack_proj_weight, pack_qkv_weight

COUNTER = counter("window_msa")
N_TOK = 64


def window_msa_plain(x, wqkv, bqkv, rel_bias, wp, bp, num_heads: int, labels=None):
    nw, n, c = x.shape
    dt = x.dtype
    dh = c // num_heads
    qkv = (x.float() @ wqkv.to(dt).float().t() + bqkv.float()).to(dt).float()
    q, k, v = qkv.reshape(nw, n, 3, num_heads, dh).permute(2, 0, 3, 1, 4)  # (NW, nH, N, dh)
    s = (q @ k.transpose(-1, -2)) * dh ** -0.5 + rel_bias.float()[None]
    if labels is not None:
        lab = labels.to(x.device).repeat(nw // labels.shape[0], 1)  # (NW, N)
        s = s.masked_fill((lab[:, :, None] != lab[:, None, :])[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1).to(dt).float()
    o = (p @ v).to(dt).float().permute(0, 2, 1, 3).reshape(nw, n, c)
    return (o @ wp.to(dt).float().t() + bp.float()).to(dt)


@lru_cache(maxsize=1)
def _entry():
    import ctypes

    return _build.entry("mp_window_msa", 8, [ctypes.c_int] * 6)


def _prepare(x, wqkv, bqkv, rel_bias, wp, bp, num_heads, labels):
    """Everything a launch needs: (the C entry's arguments, out, the tensors
    the arguments point into, to be held until the launch)."""
    nw, n, c = x.shape
    if n != N_TOK or c % num_heads:
        raise ValueError(f"window_msa takes (NW, 64, C) tokens with C % heads == 0, got {x.shape}")
    if labels is not None and (labels.shape[-1] != N_TOK or nw % labels.shape[0]):
        raise ValueError(f"labels {tuple(labels.shape)} do not tile {nw} windows of 64 tokens")
    dt, code = x.dtype, dtype_code(x)
    kc = _build.chunk("mp_window_chunk", c, num_heads, code)
    _build.check_plan("window_msa", "mp_window_msa_smem", f"C={c}, heads={num_heads}",
                      c, num_heads, code, kc)
    x = x.contiguous()
    if code:
        wq, wpk = pack_qkv_weight(wqkv, num_heads, dt), pack_proj_weight(wp, num_heads, dt)
    else:
        wq, wpk = kernel_weight(wqkv, dt), kernel_weight(wp, dt)
    bq, bpf, bias = f32(bqkv), f32(bp), f32(rel_bias)
    lab = None if labels is None else labels.to(x.device, torch.int32).contiguous()
    n_pat = 0 if lab is None else lab.shape[0]
    out = torch.empty_like(x)
    args = (x.data_ptr(), wq.data_ptr(), bq.data_ptr(), bias.data_ptr(), _build.ptr(lab),
            wpk.data_ptr(), bpf.data_ptr(), out.data_ptr(), code, nw, c, num_heads, n_pat, kc,
            stream_ptr())
    return args, out, (x, wq, wpk, bq, bpf, bias, lab)


def _launch(x, wqkv, bqkv, rel_bias, wp, bp, num_heads, labels):
    args, out, _held = _prepare(x, wqkv, bqkv, rel_bias, wp, bp, num_heads, labels)
    _build.check("mp_window_msa", _entry()(*args))
    n_pat = 0 if labels is None else labels.shape[0]
    COUNTER.record(("window_msa", x.shape[0], x.shape[2], num_heads, n_pat, str(x.dtype)))
    return out


class _WindowMsa(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, bqkv, rel_bias, wp, bp, labels, num_heads):
        fn = _launch if ROUTE.use_kernel(x) else window_msa_plain
        return fn(x, wqkv, bqkv, rel_bias, wp, bp, num_heads, labels)

    @staticmethod
    def backward(ctx, dout):
        raise RuntimeError("window_msa has no backward: the JAX package's fused window "
                           "attention (K14) defines no VJP")


def window_msa(x, wqkv, bqkv, rel_bias, wp, bp, num_heads: int, labels=None):
    """Same contract as :func:`window_msa_plain`; launches the CUDA kernel on a
    CUDA tensor. Forward only."""
    return _WindowMsa.apply(x, wqkv, bqkv, rel_bias, wp, bp, labels, num_heads)
