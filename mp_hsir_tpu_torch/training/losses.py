"""Training losses (counterparts of ``mp_hsir_tpu/training/losses.py``).

The main path is L1 on the clamped output (reference train.py:42,58-63);
GAN, Charbonnier and a differentiable SSIM loss complete the reference's
loss toolbox. Inputs are torch tensors; every loss returns a 0-dim tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l1_clamped(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """mean |clamp(pred, 0, 1) - target| (reference training_step)."""
    return (pred.clamp(0.0, 1.0) - target).abs().mean()


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def charbonnier(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    return ((pred - target).square() + eps * eps).sqrt().mean()


def gan_loss(logits: torch.Tensor, target_is_real: bool, mode: str = "lsgan") -> torch.Tensor:
    """LSGAN / vanilla GAN loss (reference: utils/loss_utils.py:6-46)."""
    target = torch.ones_like(logits) if target_is_real else torch.zeros_like(logits)
    if mode == "lsgan":
        return (logits - target).square().mean()
    if mode == "vanilla":
        return (logits.clamp_min(0) - logits * target + torch.log1p(torch.exp(-logits.abs()))).mean()
    raise ValueError(mode)


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def ssim_loss(pred: torch.Tensor, target: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """1 - SSIM with an 11x11 Gaussian window per channel, 'same' zero
    padding (utils/pytorch_ssim/__init__.py:45-78). Inputs (B, C, H, W)."""
    g = _gaussian_window(window_size).to(pred.device, pred.dtype)
    win = torch.outer(g, g)[None, None]
    b, c, h, w = pred.shape
    pad = window_size // 2

    def filt(img):
        return F.conv2d(img.reshape(b * c, 1, h, w), win, padding=pad).reshape(b, c, h, w)

    mu1, mu2 = filt(pred), filt(target)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = filt(pred * pred) - mu1_sq
    s2 = filt(target * target) - mu2_sq
    s12 = filt(pred * target) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return 1.0 - ssim_map.mean()
