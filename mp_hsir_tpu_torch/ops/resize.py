"""Separable NHWC resizing as interpolation-matrix products (counterpart of
``mp_hsir_tpu/ops/resize.py``; torch ``F.interpolate`` semantics)."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _source_coords(n_in: int, n_out: int, align_corners: bool, clamp_neg: bool) -> np.ndarray:
    if align_corners:
        if n_out == 1:
            return np.zeros(1)
        return np.arange(n_out) * (n_in - 1) / (n_out - 1)
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    return np.maximum(src, 0.0) if clamp_neg else src


@lru_cache(maxsize=256)
def _bilinear_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """(n_out, n_in) float32 row-stochastic bilinear interpolation matrix."""
    m = np.zeros((n_out, n_in), dtype=np.float64)
    src = _source_coords(n_in, n_out, align_corners, clamp_neg=not align_corners)
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    for k, wk in ((0, 1 - t), (1, t)):
        np.add.at(m, (np.arange(n_out), np.clip(i0 + k, 0, n_in - 1)), wk)
    return m.astype(np.float32)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """NHWC bilinear resize (antialias off) in float32, cast back to x's dtype."""
    h, w = x.shape[-3], x.shape[-2]
    mh = torch.as_tensor(_bilinear_matrix(h, out_h, align_corners), device=x.device)
    mw = torch.as_tensor(_bilinear_matrix(w, out_w, align_corners), device=x.device)
    y = torch.einsum("oh,...hwc->...owc", mh, x.float())
    y = torch.einsum("pw,...owc->...opc", mw, y)
    return y.to(x.dtype)


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NHWC nearest resize: src = min(floor(i*in/out), in-1) (torch 'nearest')."""
    h, w = x.shape[-3], x.shape[-2]
    hi = np.minimum((np.arange(out_h) * h / out_h).astype(np.int64), h - 1)
    wi = np.minimum((np.arange(out_w) * w / out_w).astype(np.int64), w - 1)
    hi = torch.as_tensor(hi, device=x.device)
    wi = torch.as_tensor(wi, device=x.device)
    return x.index_select(-3, hi).index_select(-2, wi)
