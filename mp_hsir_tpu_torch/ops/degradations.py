"""On-device degradation synthesis (counterpart of
``mp_hsir_tpu/ops/degradations.py``, reference utils/degradation_utils.py).

Each degradation is split into its random draws (``*_draw``: dense fields
from an explicit ``torch.Generator`` on the tensor's device) and a
deterministic apply that takes those draws, so the applies can be held
exactly against the JAX functions on the draws of the same ``jax.random``
keys. Cubes are (..., C, H, W) float32; the draws take a batch (n, C, H, W)
and return one field per sample. Nothing here reads the device back.

Masks of a fixed count ("rank of a random permutation < count", JAX's
``_rank_mask``) take the argsort of uniform draws, which is a uniformly random
permutation and, unlike ``torch.randperm``, batches over bands and samples.
"""

from __future__ import annotations

import contextlib
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mp_hsir_tpu_torch import upload
from mp_hsir_tpu_torch.ops.resize import pixel_replicate_upsample, resize_bicubic


@lru_cache(maxsize=64)
def _table(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A small float32 constant on ``device``, uploaded once."""
    return upload(np.asarray(values, np.float32), device)


def rank_mask(gen: torch.Generator, shape: Sequence[int], count, device) -> torch.Tensor:
    """Boolean ``shape`` with ``count`` True entries per row of the last axis
    at uniformly random positions; ``count`` is an int or a tensor that
    broadcasts against ``shape[:-1] + (1,)``."""
    ranks = torch.rand(tuple(shape), generator=gen, device=device).argsort(dim=-1)
    return ranks < count


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------

def gaussian_iid_draw(gen, x: torch.Tensor, sigma_range: Tuple[float, float]):
    """(sigma (n, 1, 1, 1), noise): sigma uniform in the 0-255 range / 255."""
    lo, hi = sigma_range
    u = torch.rand((x.shape[0], 1, 1, 1), generator=gen, device=x.device)
    sigma = (u * (hi - lo) + lo) / 255.0
    return sigma, torch.randn(x.shape, generator=gen, device=x.device)


def gaussian_apply(x: torch.Tensor, sigma: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """x + noise * sigma (sigma broadcast per sample, or per band)."""
    return x + noise * sigma


def gaussian_non_iid_draw(gen, x: torch.Tensor, sigmas: Sequence[float]):
    """(band sigma (n, C, 1, 1), noise): each band's sigma drawn from the set."""
    s = _table(tuple(np.asarray(sigmas, np.float32) / np.float32(255.0)), x.device)
    idx = torch.randint(0, len(sigmas), x.shape[:2], generator=gen, device=x.device)
    return s[idx][..., None, None], torch.randn(x.shape, generator=gen, device=x.device)


def _counts(gen, x, lo: int, hi: int) -> torch.Tensor:
    return torch.randint(lo, max(hi, lo + 1), x.shape[:2], generator=gen, device=x.device)


def stripe_draw(gen, x: torch.Tensor, amount: Tuple[float, float] = (0.05, 0.15),
                band_fraction: float = 1 / 3):
    """(band_mask (n, C), col_mask (n, C, W), stripe (n, C, W)): floor(C/3)
    bands; per band a count of columns in [floor(lo W), floor(hi W)); offsets
    uniform in [-0.25, 0.25)."""
    n, c, _, w = x.shape
    band_mask = rank_mask(gen, (n, c), int(np.floor(band_fraction * c)), x.device)
    counts = _counts(gen, x, int(np.floor(amount[0] * w)), int(np.floor(amount[1] * w)))
    col_mask = rank_mask(gen, (n, c, w), counts[..., None], x.device)
    stripe = torch.rand((n, c, w), generator=gen, device=x.device) * 0.5 - 0.25
    return band_mask, col_mask, stripe


def stripe_apply(x, band_mask, col_mask, stripe) -> torch.Tensor:
    delta = torch.where(band_mask[..., None] & col_mask, stripe, 0.0)
    return x - delta[..., None, :]


def deadline_draw(gen, x: torch.Tensor, amount: Tuple[float, float] = (0.05, 0.15),
                  band_fraction: float = 1 / 3):
    """(kill (n, C, W),): dead columns, per band a count in [ceil(lo W),
    ceil(hi W)), on floor(C/3) bands."""
    n, c, _, w = x.shape
    band_mask = rank_mask(gen, (n, c), int(np.floor(band_fraction * c)), x.device)
    counts = _counts(gen, x, int(np.ceil(amount[0] * w)), int(np.ceil(amount[1] * w)))
    return (band_mask[..., None] & rank_mask(gen, (n, c, w), counts[..., None], x.device),)


def deadline_apply(x, kill) -> torch.Tensor:
    return torch.where(kill[..., None, :], 0.0, x)


def impulse_draw(gen, x: torch.Tensor, amount: float, salt_vs_pepper: float = 0.5,
                 band_fraction: float = 1 / 3):
    """(band_mask (n, C), flipped, salted (n, C, H, W)): salt and pepper on
    floor(C/3) bands, each pixel flipped with probability ``amount``."""
    n, c = x.shape[:2]
    band_mask = rank_mask(gen, (n, c), int(np.floor(band_fraction * c)), x.device)
    flipped = torch.rand(x.shape, generator=gen, device=x.device) < amount
    salted = torch.rand(x.shape, generator=gen, device=x.device) < salt_vs_pepper
    return band_mask, flipped, salted


def impulse_apply(x, band_mask, flipped, salted) -> torch.Tensor:
    hit = band_mask[..., None, None] & flipped
    x = torch.where(hit & salted, 1.0, x)
    return torch.where(hit & ~salted, 0.0, x)


def poisson_draw(gen, x: torch.Tensor, scale: float = 10.0):
    """(counts,): Poisson counts of rate clip(x, 0) * scale."""
    return (torch.poisson(x.clamp(min=0.0) * scale, generator=gen),)


def poisson_apply(counts: torch.Tensor, scale: float = 10.0) -> torch.Tensor:
    return counts.float() / scale


# ---------------------------------------------------------------------------
# blur: depthwise conv with a host-built kernel
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _cudnn_tf32_off():
    """float32 convolutions in float32 (cuDNN allows TF32 by default, which
    moves a blur by ~1e-3), for the block only."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def apply_blur(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise-convolve (..., C, H, W) with a 2-D kernel, zero pad k//2
    (cross-correlation, as ``lax.conv_general_dilated`` in JAX)."""
    c, h, w = x.shape[-3:]
    k = kernel.to(x.dtype)
    xb = x.reshape(-1, c, h, w)
    with _cudnn_tf32_off():
        y = F.conv2d(xb, k.expand(c, 1, *k.shape), padding=k.shape[-1] // 2, groups=c)
    return y.reshape(x.shape)


# ---------------------------------------------------------------------------
# resolution / masking / bands / atmosphere
# ---------------------------------------------------------------------------

def sr_degrade(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Bicubic (align_corners=True) downsample by ``factor``, then pixel
    replication back to full resolution."""
    h, w = x.shape[-2:]
    low = resize_bicubic(x.movedim(-3, -1), h // factor, w // factor, align_corners=True)
    return pixel_replicate_upsample(low, factor).movedim(-1, -3)


def random_mask_draw(gen, x: torch.Tensor, mask_ratio: float):
    """(mask,): each pixel kept with probability 1 - mask_ratio."""
    return (torch.rand(x.shape, generator=gen, device=x.device) > mask_ratio,)


def mask_apply(x, mask) -> torch.Tensor:
    return x * mask


def band_loss_draw(gen, x: torch.Tensor, count: int):
    """(keep (n, C),): ``count`` bands lost per sample."""
    return (~rank_mask(gen, x.shape[:2], count, x.device),)


def band_apply(x, keep) -> torch.Tensor:
    return x * keep[..., None, None]


def simulate_haze(x: torch.Tensor, cirrus: torch.Tensor, omega, gamma: float = 1.0,
                  top_percent: float = 0.01) -> torch.Tensor:
    """Physical cirrus haze (reference degradation_utils.py:235-274); the
    cirrus template (..., H, W) must already have the cube's size."""
    c, h, w = x.shape[-3:]
    wavelength = np.linspace(400, 1000, max(100, c))
    top_k = max(int(h * w * top_percent / 100), 1)
    atmos = x.reshape(*x.shape[:-2], h * w).topk(top_k, dim=-1).values.mean(dim=-1)
    log_t1 = torch.log(torch.clamp(1 - omega * cirrus, min=1e-10))
    lam = _table(tuple((wavelength[0] / wavelength[:c]) ** gamma), x.device)
    trans = torch.exp(lam[:, None, None] * log_t1[..., None, :, :])
    return x * trans + atmos[..., None, None] * (1 - trans)


def cassi_draw(gen, x: torch.Tensor):
    """(mask (n, H, W),): a random binary coded aperture per sample."""
    n, _, h, w = x.shape
    return ((torch.rand((n, h, w), generator=gen, device=x.device) > 0.5).to(x.dtype),)


def sd_cassi(x: torch.Tensor, mask: torch.Tensor, step: int = 2) -> torch.Tensor:
    """SD-CASSI snapshot-compressive simulation: modulate, shear each band
    ``step`` columns, sum, shear back, min-max normalise per cube
    (reference degradation_utils.py:202-225)."""
    c, h, w = x.shape[-3:]
    mod = x * mask[..., None, :, :]
    meas = x.new_zeros(*x.shape[:-3], h, w + (c - 1) * step)
    for i in range(c):
        meas[..., step * i: step * i + w] += mod[..., i, :, :]
    out = torch.stack([meas[..., step * i: step * i + w] for i in range(c)], dim=-3)
    lo = out.amin(dim=(-3, -2, -1), keepdim=True)
    hi = out.amax(dim=(-3, -2, -1), keepdim=True)
    return (out - lo) / (hi - lo)
