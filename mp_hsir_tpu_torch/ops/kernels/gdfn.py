"""LayerNorm + GDFN (Restormer gated depthwise-conv FFN) over NHWC maps, with
an optional residual and an optional trailing 1x1 projection.

Kernel: ``csrc/gdfn.cu`` (replaces ``_gdfn_kernel``,
``mp_hsir_tpu/ops/pallas_attention.py:1274``). Plain version:
:func:`gdfn_plain`. Weights are conv weights in OIHW: w_in (2h, C, 1, 1),
w_dw (2h, 1, 3, 3), w_out (C, h, 1, 1), proj_w (Co, C, 1, 1).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from mp_hsir_tpu_torch.ops.basic import gelu_exact, layer_norm
from mp_hsir_tpu_torch.ops.kernels import _build
from mp_hsir_tpu_torch.ops.kernels._route import (
    ROUTE, counter, dtype_code, f32, kernel_weight, stream_ptr,
)
from mp_hsir_tpu_torch.ops.kernels.spectral import dwconv3_f32

COUNTER = counter("gdfn")


def gdfn_plain(x, ln_w, ln_b, w_in, w_dw, w_out, residual: bool = False, proj_w=None,
               eps: float = 1e-5):
    dt = x.dtype
    c = x.shape[-1]
    hid = w_out.shape[1]
    t = layer_norm(x, ln_w, ln_b, eps).float() @ w_in.to(dt).float().reshape(2 * hid, c).t()
    t = dwconv3_f32(t, w_dw.to(dt))
    gated = (gelu_exact(t[..., :hid]) * t[..., hid:]).to(dt)
    y = gated.float() @ w_out.to(dt).float().reshape(c, hid).t()
    if residual:
        y = y + x.float()
    y = y.to(dt)
    if proj_w is not None:
        y = (y.float() @ proj_w.to(dt).float().reshape(proj_w.shape[0], c).t()).to(dt)
    return y


@lru_cache(maxsize=1)
def _entry():
    import ctypes

    return _build.entry("mp_gdfn", 8, [ctypes.c_int] * 8 + [ctypes.c_float])


def gdfn(x, ln_w, ln_b, w_in, w_dw, w_out, residual: bool = False, proj_w=None,
         eps: float = 1e-5):
    """Same contract as :func:`gdfn_plain`; launches the CUDA kernel on a
    CUDA tensor."""
    if not ROUTE.use_kernel(x):
        return gdfn_plain(x, ln_w, ln_b, w_in, w_dw, w_out, residual, proj_w, eps)
    b, h, w, c = x.shape
    if h % 8 or w % 8:
        raise ValueError(f"gdfn needs H, W % 8 == 0, got {x.shape}")
    dt, code = x.dtype, dtype_code(x)
    hid = w_out.shape[1]
    co = c if proj_w is None else proj_w.shape[0]
    x = x.contiguous()
    wi, wd, wo = kernel_weight(w_in, dt), kernel_weight(w_dw, dt), kernel_weight(w_out, dt)
    wp = None if proj_w is None else kernel_weight(proj_w, dt)
    lnw, lnb = f32(ln_w), f32(ln_b)
    out = torch.empty((b, h, w, co), dtype=dt, device=x.device)
    err = _entry()(x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), wi.data_ptr(), wd.data_ptr(),
                   wo.data_ptr(), _build.ptr(wp), out.data_ptr(), code, b, h, w, c, hid, co,
                   int(residual), eps, stream_ptr())
    _build.check("mp_gdfn", err)
    COUNTER.record(("gdfn", b, h, w, c, hid, co, bool(residual), str(dt)))
    return out
