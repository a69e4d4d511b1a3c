"""Restoration metrics on device, band-parallel (counterparts of
``mp_hsir_tpu/ops/metrics.py``): per-band PSNR, SSIM with skimage
``structural_similarity`` defaults (7x7 uniform window, K1 0.01, K2 0.03,
sample covariance, border crop) and the spectral angle mapper in degrees."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def psnr_per_band(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """(..., C, H, W) -> per-band PSNR (..., C)."""
    mse = (x - y).square().mean(dim=(-2, -1))
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp_min(1e-20))


def ssim_per_band(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
                  win: int = 7) -> torch.Tensor:
    """(N, H, W) -> (N,) SSIM per band (skimage parity)."""
    x = x.float()[:, None]
    y = y.float()[:, None]
    npx = win * win
    cov_norm = npx / (npx - 1.0)

    def mean(t):  # mean over win x win windows at valid positions
        return F.avg_pool2d(t, win, stride=1)

    ux, uy = mean(x), mean(y)
    vx = cov_norm * (mean(x * x) - ux * ux)
    vy = cov_norm * (mean(y * y) - uy * uy)
    vxy = cov_norm * (mean(x * y) - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    return s.mean(dim=(-3, -2, -1))


def psnr_ssim(recovered: torch.Tensor, clean: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C, H, W) pair -> per-band (B, C) PSNR and SSIM after clipping to [0, 1]."""
    r = recovered.float().clamp(0.0, 1.0)
    c = clean.float().clamp(0.0, 1.0)
    b, ch, h, w = r.shape
    return psnr_per_band(r, c), ssim_per_band(r.reshape(b * ch, h, w),
                                              c.reshape(b * ch, h, w)).reshape(b, ch)


def compute_psnr_ssim(recovered: torch.Tensor, clean: torch.Tensor) -> Tuple[float, float, int]:
    """Mean over bands then batch; returns (psnr, ssim, batch)
    (reference utils/val_utils.py:49-69)."""
    p, s = psnr_ssim(recovered, clean)
    return float(p.mean()), float(s.mean()), int(p.shape[0])


def _missing_band_means(psnr_b: torch.Tensor, ssim_b: torch.Tensor, degraded: torch.Tensor):
    """Per-cube means over the bands that are all zero in ``degraded`` (0
    for a cube without one), and which cubes have any: ((B,) psnr, (B,)
    ssim, (B,) bool)."""
    missing = (degraded == 0).all(dim=-1).all(dim=-1)  # (B, C)
    n_missing = missing.sum(dim=1)
    denom = n_missing.clamp_min(1)
    zero = torch.zeros((), dtype=psnr_b.dtype, device=psnr_b.device)
    psnr_i = torch.where(missing, psnr_b, zero).sum(dim=1) / denom
    ssim_i = torch.where(missing, ssim_b, zero).sum(dim=1) / denom
    return psnr_i, ssim_i, n_missing > 0


def compute_psnr_ssim_missing_bands(recovered: torch.Tensor, clean: torch.Tensor,
                                    degraded: torch.Tensor) -> Tuple[float, float, int]:
    """Band completion: score only the bands that are entirely zero in the
    degraded input (reference utils/val_utils.py:71-105). Returns (psnr,
    ssim, cubes with a missing band); (0, 0, 0) when no band is missing."""
    psnr_b, ssim_b = psnr_ssim(recovered, clean)
    psnr_i, ssim_i, has = _missing_band_means(psnr_b, ssim_b, degraded)
    count = int(has.sum())
    if count == 0:
        return 0.0, 0.0, 0
    return float(psnr_i.sum()) / count, float(ssim_i.sum()) / count, count


def eval_metrics(restored: torch.Tensor, clean: torch.Tensor, degraded: torch.Tensor,
                 missing_bands: bool = False) -> torch.Tensor:
    """One cube batch's scores on the device as a stacked (4,) float32
    ``[psnr, ssim, count, sam]``, so a streaming loop reads back one small
    vector per cube. ``psnr`` and ``ssim`` are means over bands then batch
    and ``count`` the batch; with ``missing_bands`` (mode 10) they are the
    sums over the cubes that have an all-zero band in ``degraded`` of each
    cube's mean over those bands, and ``count`` the number of such cubes.
    ``sam`` is the batch's mean spectral angle in degrees."""
    psnr_b, ssim_b = psnr_ssim(restored, clean)
    sam = sam_degrees(restored, clean).mean()
    if missing_bands:
        psnr_i, ssim_i, has = _missing_band_means(psnr_b, ssim_b, degraded)
        p, s, count = psnr_i.sum(), ssim_i.sum(), has.sum().float()
    else:
        p, s = psnr_b.mean(), ssim_b.mean()
        count = torch.full((), float(psnr_b.shape[0]), device=psnr_b.device)
    return torch.stack([p, s, count, sam]).float()


def sam_degrees(recovered: torch.Tensor, clean: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B,) mean spectral angle in degrees."""
    r = recovered.float().clamp(0.0, 1.0)
    c = clean.float().clamp(0.0, 1.0)
    dot = (r * c).sum(dim=1)
    nrm = (r.square().sum(dim=1).sqrt() * c.square().sum(dim=1).sqrt()).clamp_min(1e-12)
    cos = (dot / nrm).clamp(-1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos)).mean(dim=(-2, -1))


def compute_sam(recovered: torch.Tensor, clean: torch.Tensor) -> float:
    return float(sam_degrees(recovered, clean).mean())


class AverageMeter:
    """Streaming mean (reference utils/val_utils.py:7-25)."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1) -> None:
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
