"""Swin window bookkeeping (counterparts of ``mp_hsir_tpu/ops/window.py``);
:func:`roll_hw` takes the spatial mesh axis of a row-sharded map."""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from mp_hsir_tpu_torch.parallel.mesh import Axis, axis_size, ring_next, ring_prev


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C) in row-major window order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * (h // ws) * (w // ws), ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    nw = (h // ws) * (w // ws)
    b = windows.shape[0] // nw
    c = windows.shape[-1]
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


@lru_cache(maxsize=64)
def shifted_region_map(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(H, W) int32 Swin shift-region labels in ROLLED coordinates: two
    tokens of a window may attend iff their labels match."""
    img = np.zeros((h, w), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, h - ws), slice(h - ws, h - shift), slice(h - shift, h)):
        for vs in (slice(0, w - ws), slice(w - ws, w - shift), slice(w - shift, w)):
            img[hs, vs] = cnt
            cnt += 1
    return img


@lru_cache(maxsize=64)
def shifted_window_labels(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws*ws) int32 region labels per window token."""
    img = shifted_region_map(h, w, ws, shift)
    return img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)


@lru_cache(maxsize=64)
def shifted_window_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws*ws, ws*ws) float32 additive mask {0, -100} for SW-MSA
    (reference net/MP_HSIR.py:639-660)."""
    win = shifted_window_labels(h, w, ws, shift)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def roll_hw(x: torch.Tensor, shift_h: int, shift_w: int,
            axis: Optional[Axis] = None) -> torch.Tensor:
    """Cyclic shift of (B, H, W, C), ``torch.roll(x, (sh, sw), dims=(1, 2))``.
    With ``axis`` H is sharded over the ring and the roll is global: each
    shard keeps its interior rows and takes |shift_h| boundary rows from its
    neighbour (the ring wraps as the roll does); |shift_h| <= the local H."""
    if shift_w:
        x = torch.roll(x, shifts=shift_w, dims=2)
    if not shift_h:
        return x
    if axis_size(axis) == 1:
        return torch.roll(x, shifts=shift_h, dims=1)
    h = x.shape[1]
    if abs(shift_h) > h:
        raise ValueError(f"a roll of {shift_h} rows across shards of {h} rows")
    if shift_h < 0:  # rows move up: the first |s| rows go to the shard above's tail
        s = -shift_h
        return torch.cat([x[:, s:], ring_prev(x[:, :s], axis)], dim=1)
    # rows move down: the last s rows go to the head of the shard below
    return torch.cat([ring_next(x[:, h - shift_h:], axis), x[:, :h - shift_h]], dim=1)
