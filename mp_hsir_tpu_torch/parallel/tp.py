"""Head-parallel slices of the spectral attention's weights for the
``spectral`` mesh axis (counterpart of ``mp_hsir_tpu/parallel/tp.py``).

Parameters stay full-size and replicated on every rank (one checkpoint
layout, nothing to reshard); member t of an axis of n computes only its
block of heads, whose weights it slices out of the replicated ones here:
the q, k and v rows ``[s C + t CL, s C + (t + 1) CL)`` (s = 0, 1, 2) of the
1x1 and depthwise weights, the temperature's heads ``[t nH / n, (t + 1) nH /
n)`` and the projection's input columns ``[t CL, (t + 1) CL)``, CL = C / n.

JAX needs a custom VJP for this (``tp_slice``) to scatter the slice's
gradient into a full-size zero tensor. Plain torch indexing of a parameter
does exactly that in its backward, so no ``autograd.Function`` is needed
here: a member's gradient of a sliced parameter is zero outside its block.

Gradient accounting (why the trainer's plain mean over every rank is
exact): every sliced computation feeds the forward psum over the axis.
Each member holds the same loss, so the psum's backward (the psum of the
cotangent, as JAX transposes it) hands member t n times the cotangent, and
its block's gradient arrives as n G|block_t; the mean over the axis then
gives the sum over t of G|block_t = G, the same mean that is right for the
replicated parameters (the same G on every member). A sliced weight whose
consumer did not end in the psum would be under-counted by n.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mp_hsir_tpu_torch.parallel.mesh import Axis, axis_size


class HeadBlock(NamedTuple):
    """A member's slices of one spectral attention's weights: wqkv (3 CL, C,
    1, 1), wdw (3 CL, 1, 3, 3), temperature (heads, 1, 1), wout (C, CL, 1,
    1), and its number of heads."""

    wqkv: torch.Tensor
    wdw: torch.Tensor
    temperature: torch.Tensor
    wout: torch.Tensor
    heads: int


def divides(num_heads: int, spectral: Axis | None) -> bool:
    """Whether ``num_heads`` run head-parallel over the axis (JAX's
    ``use_tp``): the axis has members and divides the heads. A block whose
    heads it does not divide runs its whole attention on every member."""
    n = axis_size(spectral)
    return n > 1 and num_heads % n == 0


def qkv_rows(w: torch.Tensor, c: int, cl: int, t: int) -> torch.Tensor:
    """Member t's q, k and v rows of a (3C, ...) weight, concatenated."""
    return torch.cat([w[s * c + t * cl:s * c + (t + 1) * cl] for s in range(3)])


def head_block(wqkv, wdw, temperature, wout, num_heads: int, spectral: Axis) -> HeadBlock:
    """Member ``spectral.index``'s :class:`HeadBlock` of the full-size
    weights wqkv (3C, C, 1, 1), wdw (3C, 1, 3, 3), temperature (nH, 1, 1)
    and wout (C, C, 1, 1)."""
    n, t = spectral.size, spectral.index
    c = wqkv.shape[1]
    heads = num_heads // n
    cl = heads * (c // num_heads)
    return HeadBlock(qkv_rows(wqkv, c, cl, t), qkv_rows(wdw, c, cl, t),
                     temperature[t * heads:(t + 1) * heads], wout[:, t * cl:(t + 1) * cl], heads)
