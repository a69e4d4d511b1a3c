"""NHWC convolutions with torch zero padding (counterpart of
``mp_hsir_tpu/ops/conv.py`` for one device).

These are the convolutions the JAX package leaves to XLA, outside any Pallas
kernel: 1x1 and depthwise convs of CrossAttention, SpectralAttention's plain
formulation and the TVSP GDFN. ``F.conv2d`` runs them here."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           padding: int = 0, groups: int = 1) -> torch.Tensor:
    """x: (B, H, W, Cin) NHWC; w: (Cout, Cin/groups, KH, KW) OIHW. Stride 1.
    Computes in x's dtype; returns a contiguous NHWC tensor."""
    xc = x.permute(0, 3, 1, 2)
    y = F.conv2d(xc, w.to(x.dtype), None if b is None else b.to(x.dtype),
                 padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                     padding: int = 1) -> torch.Tensor:
    """Depthwise conv; w: (C, 1, KH, KW)."""
    return conv2d(x, w, b, padding=padding, groups=x.shape[-1])
