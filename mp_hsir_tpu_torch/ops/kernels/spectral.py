"""Spectral (C x C, MDTA) attention as two kernels around a small fold.

Kernels: ``csrc/spectral.cu`` — ``mp_spectral_stats`` (the Gram and norm
sums: phase 0 of ``_spectral_kernel`` and the spectral half of
``_nhwc_sp0_kernel``, ``mp_hsir_tpu/ops/pallas_attention.py:1429`` and
``:362``) and ``mp_spectral_apply`` (phase 1 with its epilogues, ``:1429``).
:func:`spectral_fold` turns the sums into the C x C ``comb`` matrix in
PyTorch, as ``spectral_sharded_fold`` (``:2125``) does on the JAX split route.

Layouts at these functions: NHWC maps; wqkv (3C, C, 1, 1) and wdw
(3C, 1, 3, 3) conv weights; the optional second input ``x2`` makes the
logical input ``cat([x, x2], -1)``; ``shift`` > 0 means ``x`` is in the
rolled frame of a shifted block and is read through the roll-back.
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn.functional as F

from mp_hsir_tpu_torch.ops.basic import gelu_exact, layer_norm
from mp_hsir_tpu_torch.ops.kernels import _build
from mp_hsir_tpu_torch.ops.kernels._route import (
    ROUTE, counter, dtype_code, f32, kernel_weight, stream_ptr,
)
from mp_hsir_tpu_torch.ops.window import roll_hw

STATS = counter("spectral_stats")
APPLY = counter("spectral_apply")
MAX_PARTS = 128


def dwconv3_f32(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 depthwise conv with zero padding in float32, as nine shifted
    products summed in tap order: t (B, H, W, C), w (C, 1, 3, 3)."""
    b, h, wd, c = t.shape
    tp = F.pad(t.float(), (0, 0, 1, 1, 1, 1))
    w9 = w.float().reshape(c, 9)
    acc = torch.zeros((b, h, wd, c), dtype=torch.float32, device=t.device)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        acc = acc + tp[:, dy:dy + h, dx:dx + wd, :] * w9[:, tap]
    return acc


def _input(x, x2, shift, ln_w, ln_b, eps):
    """(raw, normalised) logical input in the unrolled frame."""
    u = roll_hw(x, shift, shift) if shift else x
    if x2 is not None:
        u = torch.cat([u, x2], dim=-1)
    return u, (layer_norm(u, ln_w, ln_b, eps) if ln_w is not None else u)


def _qkv_part(u, wqkv, wdw, lo, hi, dt):
    """dw3x3(1x1(u))[..., lo:hi], rounded to dt where the kernels round."""
    c = u.shape[-1]
    t = (u.float() @ wqkv[lo:hi].reshape(hi - lo, c).to(dt).float().t()).to(dt)
    return dwconv3_f32(t, wdw[lo:hi].to(dt)).to(dt)


def spectral_stats_plain(x, wqkv, wdw, num_heads: int, shift: int = 0, x2=None,
                         ln_w=None, ln_b=None, eps: float = 1e-5):
    """Returns (gram (B, C, dh), nq (B, nH, dh), nk (B, nH, dh)), float32."""
    _, u = _input(x, x2, shift, ln_w, ln_b, eps)
    b, h, w, c = u.shape
    dh = c // num_heads
    qk = _qkv_part(u, wqkv, wdw, 0, 2 * c, x.dtype).float().reshape(b, h * w, 2, num_heads, dh)
    q, k = qk[:, :, 0], qk[:, :, 1]
    gram = torch.einsum("bphd,bphe->bhde", q, k).reshape(b, c, dh)
    return gram, q.square().sum(dim=1), k.square().sum(dim=1)


@lru_cache(maxsize=1)
def _stats_entry():
    import ctypes

    return _build.entry("mp_spectral_stats", 12, [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int])


def spectral_stats(x, wqkv, wdw, num_heads: int, shift: int = 0, x2=None, ln_w=None,
                   ln_b=None, eps: float = 1e-5):
    """Same contract as :func:`spectral_stats_plain`; launches the CUDA kernel
    on a CUDA tensor (a per-part pass, then an in-order sum of the parts)."""
    if not ROUTE.use_kernel(x):
        return spectral_stats_plain(x, wqkv, wdw, num_heads, shift, x2, ln_w, ln_b, eps)
    b, h, w, c1 = x.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    c = c1 + c2
    if h % 8 or w % 8 or c % num_heads:
        raise ValueError(f"spectral stats needs H, W % 8 == 0 and C % heads == 0, got {x.shape}")
    dt, code = x.dtype, dtype_code(x)
    dh = c // num_heads
    x = x.contiguous()
    x2 = None if x2 is None else x2.to(dt).contiguous()
    wq, wd = kernel_weight(wqkv, dt), kernel_weight(wdw, dt)
    lnw, lnb = f32(ln_w), f32(ln_b)
    n_parts = min((h // 8) * (w // 8), MAX_PARTS)
    dev = x.device
    pg = torch.empty((b, n_parts, c * dh), dtype=torch.float32, device=dev)
    pnq = torch.empty((b, n_parts, c), dtype=torch.float32, device=dev)
    pnk = torch.empty_like(pnq)
    gram = torch.empty((b, c, dh), dtype=torch.float32, device=dev)
    nq = torch.empty((b, num_heads, dh), dtype=torch.float32, device=dev)
    nk = torch.empty_like(nq)
    err = _stats_entry()(x.data_ptr(), _build.ptr(x2), _build.ptr(lnw), _build.ptr(lnb),
                         wq.data_ptr(), wd.data_ptr(), pg.data_ptr(), pnq.data_ptr(),
                         pnk.data_ptr(), gram.data_ptr(), nq.data_ptr(), nk.data_ptr(), code,
                         b, h, w, c1, c2, num_heads, shift, eps, n_parts, stream_ptr())
    _build.check("mp_spectral_stats", err)
    STATS.record(("spectral_stats", b, h, w, c1, c2, num_heads, shift, ln_w is not None, str(dt)))
    return gram, nq, nk


def spectral_fold(gram, nq, nk, temperature, wout) -> torch.Tensor:
    """comb (B, C, C) float32, row = v channel (h, e), col = output channel:
    comb[h*dh+e, o] = sum_d softmax_e(G[d, e] / (|q_d| |k_e|) * t_h) W[(h, d), o]."""
    b, c, dh = gram.shape
    nh = c // dh
    nqs = nq.sqrt().clamp_min(1e-12)
    nks = nk.sqrt().clamp_min(1e-12)
    attn = gram.reshape(b, nh, dh, dh) / (nqs[..., :, None] * nks[..., None, :])
    attn = torch.softmax(attn * temperature.float().reshape(1, nh, 1, 1), dim=-1)
    wr = wout.float().reshape(c, c).t().reshape(nh, dh, c)  # [(h, d)][o]
    return torch.einsum("bhde,hdo->bheo", attn, wr).reshape(b, c, c).contiguous()


def spectral_apply_plain(x, comb, wqkv, wdw, shift: int = 0, x2=None, ln_w=None, ln_b=None,
                         residual: bool = False, gate=None, shortcut=None, mlp=None,
                         eps: float = 1e-5):
    """out = v @ comb [+ x * gate] [+ x] [+ shortcut], then optionally the
    PGSSTB tail ``out + fc2(a * gelu(g))``, ``[a|g] = fc1(LN2(out))``;
    ``mlp = (ln2_w, ln2_b, fc1_w (2h, C), fc1_b, fc2_w (C, h), fc2_b)``.
    ``gate`` (B, H/8, W/8, C) holds the per-window gates of the rolled frame.
    Output (B, H, W, C) in the unrolled frame."""
    dt = x.dtype
    raw, u = _input(x, x2, shift, ln_w, ln_b, eps)
    b, h, w, c = u.shape
    v = _qkv_part(u, wqkv, wdw, 2 * c, 3 * c, dt)
    y = torch.einsum("bhwc,bco->bhwo", v.float(), comb.to(dt).float()).to(dt)
    if gate is not None:
        gmap = gate.repeat_interleave(8, dim=1).repeat_interleave(8, dim=2)
        if shift:
            gmap = roll_hw(gmap, shift, shift)
        y = ((raw.float() * gmap.float()).to(dt).float() + y.float()).to(dt)
    if residual:
        y = (raw.float() + y.float()).to(dt)
    if shortcut is not None:
        y = (shortcut.float() + y.float()).to(dt)
    if mlp is not None:
        ln2_w, ln2_b, w1, b1, w2, b2 = mlp
        hid = w2.shape[1]
        hmid = layer_norm(y, ln2_w, ln2_b, eps).float() @ w1.to(dt).float().t() + b1.float()
        gated = (hmid[..., :hid] * gelu_exact(hmid[..., hid:])).to(dt)
        y = (y.float() + gated.float() @ w2.to(dt).float().t() + b2.float()).to(dt)
    return y


@lru_cache(maxsize=1)
def _apply_entry():
    import ctypes

    return _build.entry("mp_spectral_apply", 16, [ctypes.c_int] * 9 + [ctypes.c_float])


def spectral_apply(x, comb, wqkv, wdw, shift: int = 0, x2=None, ln_w=None, ln_b=None,
                   residual: bool = False, gate=None, shortcut=None, mlp=None,
                   eps: float = 1e-5):
    """Same contract as :func:`spectral_apply_plain`; launches the CUDA kernel
    on a CUDA tensor."""
    if not ROUTE.use_kernel(x):
        return spectral_apply_plain(x, comb, wqkv, wdw, shift, x2, ln_w, ln_b, residual,
                                    gate, shortcut, mlp, eps)
    b, h, w, c1 = x.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    c = c1 + c2
    if h % 8 or w % 8:
        raise ValueError(f"spectral apply needs H, W % 8 == 0, got {x.shape}")
    if gate is not None and (x2 is not None or ln_w is not None):
        raise ValueError("the gate epilogue takes one raw input")
    dt, code = x.dtype, dtype_code(x)
    x = x.contiguous()
    x2 = None if x2 is None else x2.to(dt).contiguous()
    gate = None if gate is None else gate.to(dt).contiguous()
    shortcut = None if shortcut is None else shortcut.to(dt).contiguous()
    wq, wd = kernel_weight(wqkv, dt), kernel_weight(wdw, dt)
    lnw, lnb, cb = f32(ln_w), f32(ln_b), f32(comb)
    hid = 0
    ln2w = ln2b = w1 = b1 = w2 = b2 = None
    if mlp is not None:
        ln2w, ln2b = f32(mlp[0]), f32(mlp[1])
        w1, b1 = kernel_weight(mlp[2], dt), f32(mlp[3])
        w2, b2 = kernel_weight(mlp[4], dt), f32(mlp[5])
        hid = mlp[4].shape[1]
    out = torch.empty((b, h, w, c), dtype=dt, device=x.device)
    p = _build.ptr
    err = _apply_entry()(x.data_ptr(), p(x2), p(lnw), p(lnb), wq.data_ptr(), wd.data_ptr(),
                         cb.data_ptr(), p(gate), p(shortcut), p(ln2w), p(ln2b), p(w1), p(b1),
                         p(w2), p(b2), out.data_ptr(), code, b, h, w, c1, c2, int(residual),
                         hid, shift, eps, stream_ptr())
    _build.check("mp_spectral_apply", err)
    APPLY.record(("spectral_apply", b, h, w, c1, c2, shift, ln_w is not None, bool(residual),
                  gate is not None, shortcut is not None, hid, str(dt)))
    return out
