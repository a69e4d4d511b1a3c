"""Separable NHWC resizing as interpolation-matrix products (counterpart of
``mp_hsir_tpu/ops/resize.py``; torch ``F.interpolate`` semantics: bicubic
a = -0.75, bilinear's negative-source clamp, nearest's floor rule). The
matrices are built in numpy, as the JAX package builds them, and kept on
each device once uploaded."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from mp_hsir_tpu_torch import upload


def _cubic_weight(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    at = np.abs(t)
    return np.where(
        at <= 1,
        (a + 2) * at**3 - (a + 3) * at**2 + 1,
        np.where(at < 2, a * at**3 - 5 * a * at**2 + 8 * a * at - 4 * a, 0.0),
    )


def _source_coords(n_in: int, n_out: int, align_corners: bool, clamp_neg: bool) -> np.ndarray:
    if align_corners:
        if n_out == 1:
            return np.zeros(1)
        return np.arange(n_out) * (n_in - 1) / (n_out - 1)
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    return np.maximum(src, 0.0) if clamp_neg else src


@lru_cache(maxsize=256)
def _resize_matrix(n_in: int, n_out: int, mode: str, align_corners: bool) -> np.ndarray:
    """(n_out, n_in) float32 row-stochastic interpolation matrix."""
    m = np.zeros((n_out, n_in), dtype=np.float64)
    if mode == "bicubic":
        src = _source_coords(n_in, n_out, align_corners, clamp_neg=False)
        taps = range(-1, 3)
    elif mode == "bilinear":
        src = _source_coords(n_in, n_out, align_corners, clamp_neg=not align_corners)
        taps = range(2)
    else:
        raise ValueError(mode)
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    for k in taps:
        wk = _cubic_weight(t - k) if mode == "bicubic" else (1 - t if k == 0 else t)
        np.add.at(m, (np.arange(n_out), np.clip(i0 + k, 0, n_in - 1)), wk)
    return m.astype(np.float32)


@lru_cache(maxsize=256)
def _device_matrix(n_in: int, n_out: int, mode: str, align_corners: bool,
                   device: torch.device) -> torch.Tensor:
    return upload(_resize_matrix(n_in, n_out, mode, align_corners), device)


def _separable(x: torch.Tensor, out_h: int, out_w: int, mode: str,
               align_corners: bool) -> torch.Tensor:
    """x: (..., H, W, C) -> (..., out_h, out_w, C), two float32 products, cast
    back to x's dtype."""
    h, w = x.shape[-3], x.shape[-2]
    return _apply(x, _device_matrix(h, out_h, mode, align_corners, x.device),
                  _device_matrix(w, out_w, mode, align_corners, x.device))


def _apply(x: torch.Tensor, mh: torch.Tensor, mw: torch.Tensor) -> torch.Tensor:
    y = torch.einsum("oh,...hwc->...owc", mh, x.float())
    y = torch.einsum("pw,...owc->...opc", mw, y)
    return y.to(x.dtype)


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int,
                   align_corners: bool = False) -> torch.Tensor:
    """NHWC bicubic resize (antialias off)."""
    return _separable(x, out_h, out_w, "bicubic", align_corners)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """NHWC bilinear resize (antialias off)."""
    return _separable(x, out_h, out_w, "bilinear", align_corners)


def resize_bilinear_row_block(x: torch.Tensor, global_out_h: int, out_w: int, row_start: int,
                              rows: int, align_corners: bool = False) -> torch.Tensor:
    """Rows ``row_start .. row_start + rows`` of the bilinear resize of x to
    (global_out_h, out_w): a shard's row block of the global resize of a
    source every shard holds whole."""
    h, w = x.shape[-3], x.shape[-2]
    mh = _device_matrix(h, global_out_h, "bilinear", align_corners, x.device)
    return _apply(x, mh[row_start:row_start + rows],
                  _device_matrix(w, out_w, "bilinear", align_corners, x.device))


@lru_cache(maxsize=256)
def _nearest_index(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """src = min(floor(i * in / out), in - 1) on ``device``, copied once."""
    return upload(np.minimum((np.arange(n_out) * n_in / n_out).astype(np.int64), n_in - 1),
                  device)


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NHWC nearest resize (torch 'nearest')."""
    h, w = x.shape[-3], x.shape[-2]
    return (x.index_select(-3, _nearest_index(h, out_h, x.device))
            .index_select(-2, _nearest_index(w, out_w, x.device)))


def pixel_replicate_upsample(x: torch.Tensor, r: int) -> torch.Tensor:
    """Repeat every pixel of an NHWC tensor r x r times (the reference's
    'resize' that blows a downsampled cube back to full resolution,
    utils/degradation_utils.py:189-200)."""
    *lead, h, w, c = x.shape
    y = x[..., :, None, :, None, :].expand(*lead, h, r, w, r, c)
    return y.reshape(*lead, h * r, w * r, c)
