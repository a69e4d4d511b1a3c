"""NHWC convolutions with torch zero padding, shard-aware on the H axis
(counterpart of ``mp_hsir_tpu/ops/conv.py``).

These are the convolutions the JAX package leaves to XLA, outside any Pallas
kernel: 1x1 and depthwise convs of CrossAttention and the TVSP GDFN.
``F.conv2d`` runs them here. With an ``axis`` (a row shard of a map split
over the spatial mesh axis) the H padding becomes a halo exchange with the
ring neighbours, zero at the image's top and bottom, so the result equals
the unsharded conv's rows of this shard."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mp_hsir_tpu_torch.parallel.mesh import Axis, axis_size, edge_rows


def halo_exchange_h(x: torch.Tensor, pad: int, axis: Optional[Axis]) -> torch.Tensor:
    """(B, H, W, C) with ``pad`` rows of the neighbour shards above and
    below (zero at the image's edges): torch's zero padding of H on the
    unsharded map, seen from this shard."""
    above, below, top, bottom = edge_rows(x, axis, pad)
    if top:
        above = torch.zeros_like(above)
    if bottom:
        below = torch.zeros_like(below)
    return torch.cat([above, x, below], dim=1)


def extend_rows(x: torch.Tensor, axis: Optional[Axis], block: int = 8):
    """A row shard of (B, H, W, C) extended by ``block`` rows on each side
    that has a neighbour shard: that neighbour's adjacent row, with
    ``block`` - 1 zero rows beyond it (so H stays a multiple of ``block``).
    Returns (the extended map, rows added above, rows added below). A 3x3
    stencil over it is exact at every row of the shard; the caller crops the
    added rows (scaled by the op's resampling) off its output."""
    above, below, top, bottom = edge_rows(x, axis, 1)
    b, _, w, c = x.shape
    pad = x.new_zeros((b, block - 1, w, c))
    parts = ([] if top else [pad, above]) + [x] + ([] if bottom else [below, pad])
    return torch.cat(parts, dim=1), 0 if top else block, 0 if bottom else block


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           padding: int = 0, groups: int = 1, axis: Optional[Axis] = None) -> torch.Tensor:
    """x: (B, H, W, Cin) NHWC; w: (Cout, Cin/groups, KH, KW) OIHW. Stride 1.
    Computes in x's dtype; returns a contiguous NHWC tensor. ``axis``: H is
    sharded over it, and its padding is a halo exchange."""
    ph = padding
    if padding and axis_size(axis) > 1:
        x, ph = halo_exchange_h(x, padding, axis), 0
    xc = x.permute(0, 3, 1, 2)
    y = F.conv2d(xc, w.to(x.dtype), None if b is None else b.to(x.dtype),
                 padding=(ph, padding), groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                     padding: int = 1, axis: Optional[Axis] = None) -> torch.Tensor:
    """Depthwise conv; w: (C, 1, KH, KW)."""
    return conv2d(x, w, b, padding=padding, groups=x.shape[-1], axis=axis)
