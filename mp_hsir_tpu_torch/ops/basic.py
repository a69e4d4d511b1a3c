"""Elementwise and reshape primitives over NHWC tensors (counterparts of
``mp_hsir_tpu/ops/basic.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as torch ``F.gelu`` and the reference use."""
    return F.gelu(x, approximate="none")


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in float32 (biased variance, eps inside
    the sqrt), cast back to x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def layer_norm_biasfree(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Bias-free LayerNorm: scale by the centred variance, keep the mean
    (reference net/MP_HSIR.py:336-338)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC PixelShuffle in torch channel order:
    ``out[b, h*r+i, w*r+j, c] = in[b, h, w, c*r*r + i*r + j]``."""
    b, h, w, c = x.shape
    if c % (r * r):
        raise ValueError(f"channels {c} not divisible by r^2={r * r}")
    co = c // (r * r)
    x = x.reshape(b, h, w, co, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, co)


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC PixelUnshuffle, the inverse of :func:`pixel_shuffle`."""
    b, h, w, c = x.shape
    if h % r or w % r:
        raise ValueError(f"spatial dims {(h, w)} not divisible by {r}")
    x = x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // r, w // r, c * r * r)
