"""LayerNorm + GDFN (Restormer gated depthwise-conv FFN) over NHWC maps, with
an optional residual and an optional trailing 1x1 projection.

Kernel: ``csrc/gdfn.cu`` (replaces ``_gdfn_kernel``,
``mp_hsir_tpu/ops/pallas_attention.py:1274``; backward ``mp_gdfn_bwd`` +
``csrc/grad.cu`` replace ``_gdfn_bwd_kernel``,
``mp_hsir_tpu/ops/pallas_vjp.py:342``). Plain versions: :func:`gdfn_plain`,
:func:`gdfn_bwd_plain`. Weights are conv weights in OIHW: w_in
(2h, C, 1, 1), w_dw (2h, 1, 3, 3), w_out (C, h, 1, 1), proj_w (Co, C, 1, 1).
The exit projection ``proj_w`` is eval-only (no backward), as in JAX.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from mp_hsir_tpu_torch.ops.basic import gelu_exact, layer_norm
from mp_hsir_tpu_torch.ops.kernels import _build
from mp_hsir_tpu_torch.ops.kernels._grad import (
    dwconv3_bwd_plain, dwconv3_f32, dwconv_bwd, ln_bwd_plain, ln_linear_bwd, ln_stats, wgrad,
)
from mp_hsir_tpu_torch.ops.kernels._route import (
    ROUTE, counter, dtype_code, f32, kernel_weight, stream_ptr,
)

COUNTER = counter("gdfn")
BWD = counter("gdfn_bwd")


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


def gdfn_bwd_plain(x, ln_w, ln_b, w_in, w_dw, w_out, residual, eps, dy):
    """Explicit VJP of :func:`gdfn_plain` without ``proj_w``: returns (dx,
    d ln_w, d ln_b, d w_in, d w_dw, d w_out), weight cotangents float32."""
    dt = x.dtype
    b, h, w, c = x.shape
    hid = w_out.shape[1]
    win = w_in.to(dt).float().reshape(2 * hid, c)
    wout = w_out.to(dt).float().reshape(c, hid)
    xhat, rstd = ln_stats(x, eps)
    xn = layer_norm(x, ln_w, ln_b, eps).float()
    t = xn @ win.t()
    a = dwconv3_f32(t, w_dw.to(dt))
    a1, a2 = a[..., :hid], a[..., hid:]
    gated = (gelu_exact(a1) * a2).to(dt).float()
    dyf = dy.float()
    dg = dyf @ wout
    phi = torch.exp(-0.5 * a1 * a1) * (2 * torch.pi) ** -0.5
    dgelu = 0.5 * (1 + torch.erf(a1 * 2 ** -0.5)) + a1 * phi
    da = torch.cat([dg * a2 * dgelu, dg * gelu_exact(a1)], dim=-1)
    dtt, dwdw = dwconv3_bwd_plain(da, t, w_dw.to(dt))
    dtt = dtt.to(dt).float()
    dw_in = dtt.reshape(-1, 2 * hid).t() @ xn.reshape(-1, c)
    dw_out = dyf.reshape(-1, c).t() @ gated.reshape(-1, hid)
    dx, dlnw, dlnb = ln_bwd_plain(dtt @ win, xhat, rstd, ln_w)
    if residual:
        dx = dx + dyf
    return (dx.to(dt), dlnw, dlnb, dw_in.reshape(2 * hid, c, 1, 1), dwdw,
            dw_out.reshape(c, hid, 1, 1))


@lru_cache(maxsize=None)
def _entry(bwd: bool = False):
    import ctypes

    if bwd:
        return _build.entry("mp_gdfn_bwd", 11, [ctypes.c_int] * 7 + [ctypes.c_float])
    return _build.entry("mp_gdfn", 8, [ctypes.c_int] * 9 + [ctypes.c_float])


def _launch(x, ln_w, ln_b, w_in, w_dw, w_out, residual, proj_w, eps):
    b, h, w, c = x.shape
    if h % 8 or w % 8:
        raise ValueError(f"gdfn needs H, W % 8 == 0, got {x.shape}")
    dt, code = x.dtype, dtype_code(x)
    hid = w_out.shape[1]
    co = c if proj_w is None else proj_w.shape[0]
    kc = _build.chunk("mp_gdfn_chunk", c)
    _build.check_plan("gdfn", "mp_gdfn_smem", f"C={c}", c, kc)
    x = x.contiguous()
    wi, wd, wo = kernel_weight(w_in, dt), kernel_weight(w_dw, dt), kernel_weight(w_out, dt)
    wp = None if proj_w is None else kernel_weight(proj_w, dt)
    lnw, lnb = f32(ln_w), f32(ln_b)
    out = torch.empty((b, h, w, co), dtype=dt, device=x.device)
    err = _entry()(x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), wi.data_ptr(), wd.data_ptr(),
                   wo.data_ptr(), _build.ptr(wp), out.data_ptr(), code, b, h, w, c, hid, co,
                   int(residual), kc, eps, stream_ptr())
    _build.check("mp_gdfn", err)
    COUNTER.record(("gdfn", b, h, w, c, hid, co, bool(residual), str(dt)))
    return out


def _bwd_launch(x, ln_w, ln_b, w_in, w_dw, w_out, residual, eps, dy):
    b, h, w, c = x.shape
    dt = x.dtype
    hid = w_out.shape[1]
    kc = _build.chunk("mp_gdfn_bwd_chunk", c)
    _build.check_plan("gdfn_bwd", "mp_gdfn_bwd_smem", f"C={c}", c, kc)
    x, dy = x.contiguous(), dy.to(dt).contiguous()
    wi, wd, wo = kernel_weight(w_in, dt), kernel_weight(w_dw, dt), kernel_weight(w_out, dt)
    lnw, lnb = f32(ln_w), f32(ln_b)
    dev = x.device
    xn = torch.empty_like(x)
    t = torch.empty((b, h, w, 2 * hid), dtype=torch.float32, device=dev)
    dc = torch.empty_like(t)
    gated = torch.empty((b, h, w, hid), dtype=dt, device=dev)
    err = _entry(True)(x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), wi.data_ptr(), wd.data_ptr(),
                       wo.data_ptr(), dy.data_ptr(), xn.data_ptr(), t.data_ptr(), dc.data_ptr(),
                       gated.data_ptr(), dtype_code(x), b, h, w, c, hid, kc, eps, stream_ptr())
    _build.check("mp_gdfn_bwd", err)
    dtt, dwdw = dwconv_bwd(dc, t, wd, 0, dt)
    dx, (dlnw, dlnb), _ = ln_linear_bwd(dtt, wi, 0, x, ln_w, extra_t=dy if residual else None,
                                        eps=eps)
    dw_in = wgrad(xn.reshape(-1, c), dtt.reshape(-1, 2 * hid)).t()
    dw_out = wgrad(gated.reshape(-1, hid), dy.reshape(-1, c)).t()
    BWD.record(("gdfn_bwd", b, h, w, c, hid, bool(residual), str(dt)))
    return (dx, dlnw, dlnb, dw_in.reshape(2 * hid, c, 1, 1), dwdw.t().reshape(2 * hid, 1, 3, 3),
            dw_out.reshape(c, hid, 1, 1))


class _Gdfn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w_in, w_dw, w_out, proj_w, cfg):
        residual, eps = cfg
        ctx.kernel = ROUTE.use_kernel(x)
        out = (_launch if ctx.kernel else gdfn_plain)(x, ln_w, ln_b, w_in, w_dw, w_out, residual,
                                                      proj_w, eps)
        ctx.cfg = cfg
        ctx.has_proj = proj_w is not None
        ctx.save_for_backward(x, ln_w, ln_b, w_in, w_dw, w_out)
        return out

    @staticmethod
    def backward(ctx, dy):
        if ctx.has_proj:
            raise RuntimeError("gdfn: no backward for the eval-only exit projection proj_w "
                               "(the training route applies PromptFusion's 1x1 conv outside)")
        x = ctx.saved_tensors[0]
        if ctx.kernel:
            fn = _bwd_launch
        else:
            ROUTE.count_plain_backward(x)
            fn = gdfn_bwd_plain
        return (*fn(*ctx.saved_tensors, *ctx.cfg, dy.contiguous()), None, None)


def gdfn(x, ln_w, ln_b, w_in, w_dw, w_out, residual: bool = False, proj_w=None,
         eps: float = 1e-5):
    """Same contract as :func:`gdfn_plain`, differentiable without
    ``proj_w``; launches the CUDA kernels on a CUDA tensor."""
    return _Gdfn.apply(x, ln_w, ln_b, w_in, w_dw, w_out, proj_w, (bool(residual), eps))
