"""LayerNorm + 8x8 shifted-window attention + projection + window means.

Kernel: ``csrc/window_attention.cu`` (replaces the TPU kernels
``_nhwc_kernel`` and the window half of ``_nhwc_sp0_kernel``,
``mp_hsir_tpu/ops/pallas_attention.py:198`` and ``:362``).
Plain version: :func:`window_attention_plain`, the same arithmetic in PyTorch.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from mp_hsir_tpu_torch.ops.basic import layer_norm
from mp_hsir_tpu_torch.ops.kernels import _build
from mp_hsir_tpu_torch.ops.kernels._route import (
    ROUTE, counter, dtype_code, f32, kernel_weight, stream_ptr,
)
from mp_hsir_tpu_torch.ops.window import (
    roll_hw, shifted_region_map, window_partition, window_reverse,
)

WS = 8
COUNTER = counter("window_attention")


@lru_cache(maxsize=32)
def region_labels(h: int, w: int, shift: int, device: torch.device) -> torch.Tensor:
    """(H, W) int32 shift-region labels of the rolled frame, on ``device``."""
    return torch.as_tensor(shifted_region_map(h, w, WS, shift), device=device)


def window_attention_plain(x, ln_w, ln_b, wqkv, bqkv, rel_bias, wp, bp, num_heads: int,
                           shift: int = 0, eps: float = 1e-5):
    """x (B, H, W, C) unrolled; wqkv (3C, C), bqkv (3C,), rel_bias (nH, 64, 64),
    wp (C, C), bp (C,). Returns (out (B, H, W, C) in the rolled frame,
    pooled (B, H/8, W/8, C) window means)."""
    b, h, w, c = x.shape
    dt = x.dtype
    dh = c // num_heads
    xr = roll_hw(x, -shift, -shift) if shift else x
    xn = window_partition(layer_norm(xr, ln_w, ln_b, eps), WS).float()  # (Bw, 64, C)
    qkv = (xn @ wqkv.to(dt).float().t() + bqkv.float()).to(dt).float()
    bw, n = qkv.shape[:2]
    qkv = qkv.reshape(bw, n, 3, num_heads, dh).permute(2, 0, 3, 1, 4)  # (3, Bw, nH, N, dh)
    s = (qkv[0] @ qkv[1].transpose(-1, -2)) * dh ** -0.5 + rel_bias.float()[None]
    if shift:
        lab = window_partition(region_labels(h, w, shift, x.device)[None, :, :, None], WS)[..., 0]
        mask = torch.where(lab[:, :, None] != lab[:, None, :], -100.0, 0.0)  # (nW, N, N)
        s = (s.reshape(b, -1, num_heads, n, n) + mask[None, :, None]).reshape(bw, num_heads, n, n)
    p = torch.softmax(s, dim=-1).to(dt).float()
    o = (p @ qkv[2]).to(dt).float()  # (Bw, nH, N, dh)
    o = o.permute(0, 2, 1, 3).reshape(bw, n, c)
    y = (o @ wp.to(dt).float().t() + bp.float()).to(dt)
    pooled = y.float().mean(dim=1).to(dt).reshape(b, h // WS, w // WS, c)
    return window_reverse(y, WS, h, w), pooled


@lru_cache(maxsize=1)
def _entry():
    import ctypes

    return _build.entry("mp_window_attention", 11,
                        [ctypes.c_int] * 7 + [ctypes.c_float])


def window_attention(x, ln_w, ln_b, wqkv, bqkv, rel_bias, wp, bp, num_heads: int,
                     shift: int = 0, eps: float = 1e-5):
    """Same contract as :func:`window_attention_plain`; launches the CUDA
    kernel on a CUDA tensor."""
    if not ROUTE.use_kernel(x):
        return window_attention_plain(x, ln_w, ln_b, wqkv, bqkv, rel_bias, wp, bp,
                                      num_heads, shift, eps)
    b, h, w, c = x.shape
    if h % WS or w % WS or c % num_heads:
        raise ValueError(f"window attention needs H, W % 8 == 0 and C % heads == 0, got {x.shape}")
    dt = x.dtype
    code = dtype_code(x)
    x = x.contiguous()
    wq, wpk = kernel_weight(wqkv, dt), kernel_weight(wp, dt)
    lnw, lnb, bq, bpf, bias = f32(ln_w), f32(ln_b), f32(bqkv), f32(bp), f32(rel_bias)
    labels = region_labels(h, w, shift, x.device) if shift else None
    out = torch.empty_like(x)
    pooled = torch.empty((b, h // WS, w // WS, c), dtype=dt, device=x.device)
    err = _entry()(x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), wq.data_ptr(), bq.data_ptr(),
                   bias.data_ptr(), _build.ptr(labels), wpk.data_ptr(), bpf.data_ptr(),
                   out.data_ptr(), pooled.data_ptr(), code, b, h, w, c, num_heads, shift,
                   eps, stream_ptr())
    _build.check("mp_window_attention", err)
    COUNTER.record(("window_attention", b, h, w, c, num_heads, shift, str(dt)))
    return out, pooled


def relative_position_index(ws: int = WS) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2ws-1)^2 relative-position table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)
