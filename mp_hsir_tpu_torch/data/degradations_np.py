"""Host-side (NumPy) degradation synthesis for evaluation datasets: a copy of
``mp_hsir_tpu/data/degradations_np.py``.

Same math as the reference degradation engine
(utils/degradation_utils.py:18-434) and the per-task test datasets
(utils/dataset_utils.py:212-879), driven by an explicit
``np.random.Generator``. Cubes are (C, H, W) float32 in [0, 1].

The JAX package calls OpenCV for three steps; this copy computes them in
numpy instead, with OpenCV's own arithmetic, so it runs where OpenCV is not
installed: ``cv2.resize`` INTER_CUBIC (``_cv_resize_cubic``: bit-exact on
float64), INTER_LINEAR (``_cv_resize_linear``: within one float32 ulp) and
``cv2.warpAffine`` INTER_LINEAR with a zero border (``_cv_warp_affine``:
bit-exact, its 1/32-pixel fixed-point coordinates included). The bicubic
downsample uses this package's matrix resize. Training-time synthesis runs on
the device (``mp_hsir_tpu_torch/ops/degradations.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# OpenCV's interpolation, in numpy
# ---------------------------------------------------------------------------

def _cv_cubic_taps(n_in: int, n_out: int):
    """Source indices (n_out, 4), border replicated, and float32 weights of
    OpenCV's resize INTER_CUBIC (``interpolateCubic``, A = -0.75)."""
    fx = ((np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    x = fx - sx.astype(np.float32)
    a, one = np.float32(-0.75), np.float32(1)
    c0 = ((a * (x + one) - np.float32(5) * a) * (x + one) + np.float32(8) * a) * (x + one) - np.float32(4) * a
    c1 = ((a + np.float32(2)) * x - (a + np.float32(3))) * x * x + one
    c2 = ((a + np.float32(2)) * (one - x) - (a + np.float32(3))) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(sx[:, None] + np.arange(-1, 3)[None], 0, n_in - 1)
    return idx, np.stack([c0, c1, c2, c3], 1)


def _cv_linear_taps(n_in: int, n_out: int):
    """Source indices (n_out, 2) and float32 weights of OpenCV's resize
    INTER_LINEAR (outside the image: the edge pixel, weight 1)."""
    fx = ((np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    x = fx - sx.astype(np.float32)
    edge = (sx < 0) | (sx >= n_in - 1)
    x = np.where(edge, np.float32(0), x)
    sx = np.clip(sx, 0, n_in - 1)
    idx = np.stack([sx, np.minimum(sx + 1, n_in - 1)], 1)
    return idx, np.stack([np.float32(1) - x, x], 1)


def _cv_resize(a: np.ndarray, w: int, h: int, taps) -> np.ndarray:
    """Rows first, then columns, each output a left-to-right sum of taps in
    ``a``'s dtype (OpenCV's order)."""
    ix, cx = taps(a.shape[1], w)
    iy, cy = taps(a.shape[0], h)
    cx, cy = cx.astype(a.dtype), cy.astype(a.dtype)
    rows = a[:, ix[:, 0]] * cx[:, 0]
    for k in range(1, ix.shape[1]):
        rows = rows + a[:, ix[:, k]] * cx[:, k]
    out = cy[:, 0:1] * rows[iy[:, 0]]
    for k in range(1, iy.shape[1]):
        out = out + cy[:, k:k + 1] * rows[iy[:, k]]
    return out


def _cv_resize_cubic(a: np.ndarray, w: int, h: int) -> np.ndarray:
    """``cv2.resize(a, (w, h), interpolation=cv2.INTER_CUBIC)``."""
    return _cv_resize(np.asarray(a), w, h, _cv_cubic_taps)


def _cv_resize_linear(a: np.ndarray, w: int, h: int) -> np.ndarray:
    """``cv2.resize(a, (w, h), interpolation=cv2.INTER_LINEAR)``."""
    return _cv_resize(np.asarray(a), w, h, _cv_linear_taps)


def _cv_rotation_matrix(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``."""
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _cv_warp_affine(src: np.ndarray, m: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(src, m, dsize)`` for a 2-D float64 ``src``
    (INTER_LINEAR, zero border): the inverse map in double, source
    coordinates in 10-bit fixed point rounded to 1/32 pixel, bilinear weights
    of those 32nds."""
    m = np.asarray(m, np.float64).reshape(6).copy()
    det = m[0] * m[4] - m[1] * m[3]
    det = 1.0 / det if det != 0 else 0.0
    m[0], m[4] = m[4] * det, m[0] * det
    m[1] *= -det
    m[3] *= -det
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    w, h = dsize
    ab_bits, inter_bits = 10, 5
    ab_scale, tab = 1 << ab_bits, 1 << inter_bits
    round_delta = ab_scale // tab // 2
    xs = np.arange(w)
    adelta = np.rint(m[0] * xs * ab_scale).astype(np.int64)
    bdelta = np.rint(m[3] * xs * ab_scale).astype(np.int64)
    sh, sw = src.shape
    one = np.float32(1)

    def at(yy, xx):
        ok = (yy >= 0) & (yy < sh) & (xx >= 0) & (xx < sw)
        return np.where(ok, src[np.clip(yy, 0, sh - 1), np.clip(xx, 0, sw - 1)], 0.0)

    out = np.zeros((h, w), np.float64)
    for y in range(h):
        x0 = int(np.rint((m[1] * y + m[2]) * ab_scale)) + round_delta
        y0 = int(np.rint((m[4] * y + m[5]) * ab_scale)) + round_delta
        gx = (x0 + adelta) >> (ab_bits - inter_bits)
        gy = (y0 + bdelta) >> (ab_bits - inter_bits)
        sx, sy = gx >> inter_bits, gy >> inter_bits
        fx = (gx & (tab - 1)).astype(np.float32) / np.float32(tab)
        fy = (gy & (tab - 1)).astype(np.float32) / np.float32(tab)
        out[y] = (at(sy, sx) * ((one - fy) * (one - fx)) + at(sy, sx + 1) * ((one - fy) * fx)
                  + at(sy + 1, sx) * (fy * (one - fx)) + at(sy + 1, sx + 1) * (fy * fx))
    return out


# ---------------------------------------------------------------------------
# noise families
# ---------------------------------------------------------------------------

def gaussian_noise_iid(x: np.ndarray, rng: np.random.Generator, sigma_range: Tuple[float, float]) -> np.ndarray:
    """iid Gaussian noise with sigma drawn uniformly in [lo, hi] (on the
    0-255 scale, divided by 255)."""
    lo, hi = sigma_range
    sigma = rng.uniform(lo, hi) / 255.0
    return (x + rng.standard_normal(x.shape) * sigma).astype(np.float32)


def gaussian_noise_fixed(x: np.ndarray, rng: np.random.Generator, sigma: float) -> np.ndarray:
    return (x + rng.standard_normal(x.shape) * (sigma / 255.0)).astype(np.float32)


def gaussian_noise_non_iid(x: np.ndarray, rng: np.random.Generator, sigmas: Sequence[float]) -> np.ndarray:
    """Per-band sigma drawn from a discrete set (non-iid over bands)."""
    s = np.asarray(sigmas, np.float64) / 255.0
    bw = s[rng.integers(0, len(s), x.shape[0])].reshape(-1, 1, 1)
    return (x + rng.standard_normal(x.shape) * bw).astype(np.float32)


def stripe_noise(
    x: np.ndarray, rng: np.random.Generator, amount: Tuple[float, float], band_fraction: float = 1 / 3
) -> np.ndarray:
    """Additive column stripes on a random third of the bands."""
    b, h, w = x.shape
    out = x.copy()
    n_bands = int(np.floor(band_fraction * b))
    bands = rng.permutation(b)[:n_bands]
    lo, hi = amount
    counts = rng.integers(int(np.floor(lo * w)), int(np.floor(hi * w)), n_bands)
    for bi, n in zip(bands, counts):
        cols = rng.permutation(w)[:n]
        stripe = rng.uniform(0, 1, size=len(cols)) * 0.5 - 0.25
        out[bi, :, cols] -= stripe[:, None]
    return out.astype(np.float32)


def deadline_noise(
    x: np.ndarray, rng: np.random.Generator, amount: Tuple[float, float] = (0.05, 0.15), band_fraction: float = 1 / 3
) -> np.ndarray:
    """Zeroed ("dead") columns on a random third of the bands."""
    b, h, w = x.shape
    out = x.copy()
    n_bands = int(np.floor(band_fraction * b))
    bands = rng.permutation(b)[:n_bands]
    lo, hi = amount
    counts = rng.integers(int(np.ceil(lo * w)), int(np.ceil(hi * w)), n_bands)
    for bi, n in zip(bands, counts):
        cols = rng.permutation(w)[:n]
        out[bi, :, cols] = 0.0
    return out.astype(np.float32)


def impulse_noise(
    x: np.ndarray, rng: np.random.Generator, amount: float, salt_vs_pepper: float = 0.5, band_fraction: float = 1 / 3
) -> np.ndarray:
    """Salt & pepper on a random third of the bands."""
    b, h, w = x.shape
    out = x.copy()
    n_bands = int(np.floor(band_fraction * b))
    bands = rng.permutation(b)[:n_bands]
    for bi in bands:
        flipped = rng.random((h, w)) < amount
        salted = rng.random((h, w)) < salt_vs_pepper
        out[bi][flipped & salted] = 1.0
        out[bi][flipped & ~salted] = 0.0
    return out.astype(np.float32)


def poisson_noise(x: np.ndarray, rng: np.random.Generator, scale: float = 10.0) -> np.ndarray:
    return (rng.poisson(np.clip(x, 0, None) * scale) / scale).astype(np.float32)


# ---------------------------------------------------------------------------
# blur kernels (separable depthwise convs)
# ---------------------------------------------------------------------------

def gaussian_blur_kernel(ksize: int) -> np.ndarray:
    """2-D Gaussian kernel with OpenCV's sigma rule
    sigma = 0.3*((k-1)*0.5 - 1) + 0.8 (reference: degradation_utils.py:93)."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64)
    mean = (ksize - 1) / 2
    k1 = np.exp(-((xs - mean) ** 2) / (2 * sigma**2))
    k1 /= k1.sum()
    return np.outer(k1, k1).astype(np.float32)


def circle_blur_kernel(ksize: int) -> np.ndarray:
    radius = ksize // 2
    center = ksize // 2
    yy, xx = np.mgrid[0:ksize, 0:ksize]
    dist = np.sqrt((xx - center) ** 2 + (yy - center) ** 2)
    k = np.where(dist <= radius, np.exp(-(dist**2) / (2 * radius**2)), 0.0)
    return (k / k.sum()).astype(np.float32)


def square_blur_kernel(ksize: int) -> np.ndarray:
    return np.full((ksize, ksize), 1.0 / (ksize * ksize), np.float32)


def motion_blur_kernel(ksize: int, angle: float) -> np.ndarray:
    """Line kernel rotated by `angle` degrees as cv2 warpAffine rotates it
    (the reference's construction; degradation_utils.py:130-137)."""
    k = np.zeros((ksize, ksize))
    k[int((ksize - 1) / 2), :] = 1.0 / ksize
    rot = _cv_rotation_matrix((ksize / 2, ksize / 2), angle, 1)
    return _cv_warp_affine(k, rot, (ksize, ksize)).astype(np.float32)


def apply_blur(x: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Depthwise 2-D convolution, zero padding k//2 (cross-correlation, like
    torch F.conv2d)."""
    from scipy.signal import fftconvolve

    k = kernel[::-1, ::-1]  # fftconvolve flips; torch conv2d does not
    pad = kernel.shape[0] // 2
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad)))
    out = np.stack([fftconvolve(xp[c], k, mode="valid") for c in range(x.shape[0])])
    # fftconvolve 'valid' on padded input of odd kernel reproduces 'same'
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# resolution / masking / atmosphere
# ---------------------------------------------------------------------------

def bicubic_downsample(x: np.ndarray, factor: int) -> np.ndarray:
    """torch bicubic align_corners=True downsample (reference:
    degradation_utils.py:165-176) through this package's matrix resize."""
    import torch

    from mp_hsir_tpu_torch.ops.resize import resize_bicubic

    c, h, w = x.shape
    nhwc = torch.from_numpy(np.ascontiguousarray(x.transpose(1, 2, 0), np.float32))[None]
    y = resize_bicubic(nhwc, h // factor, w // factor, align_corners=True)
    return y[0].numpy().transpose(2, 0, 1).astype(np.float32)


def pixel_replicate(x: np.ndarray, factor: int) -> np.ndarray:
    """Nearest pixel-replication upsample used to return SR inputs to full
    resolution (reference: degradation_utils.py:189-200)."""
    return np.repeat(np.repeat(x, factor, axis=1), factor, axis=2).astype(np.float32)


def sr_degrade(x: np.ndarray, factor: int) -> np.ndarray:
    return pixel_replicate(bicubic_downsample(x, factor), factor)


def random_mask(x: np.ndarray, rng: np.random.Generator, mask_ratio: float):
    mask = rng.random(x.shape) > mask_ratio
    return (x * mask).astype(np.float32), mask


def band_loss(x: np.ndarray, rng: np.random.Generator, loss_percentage: float) -> np.ndarray:
    b = x.shape[0]
    n = int(loss_percentage * b)
    idx = rng.choice(b, n, replace=False)
    out = x.copy()
    out[idx] = 0.0
    return out.astype(np.float32)


def simulate_haze(
    x: np.ndarray,
    cirrus: np.ndarray,
    omega: float = 0.5,
    gamma: float = 1.0,
    top_percent: float = 0.01,
) -> np.ndarray:
    """Physical cirrus haze model (reference: degradation_utils.py:235-274).

    cirrus: (H', W') haze transmission template, resized bilinearly (as
    cv2 INTER_LINEAR) to the cube's spatial dims. Atmospheric light per
    band = mean of the brightest top_percent% pixels. Wavelength-dependent transmission:
    t_b = t1 ** ((lambda_0 / lambda_b) ** gamma).
    """
    c, h, w = x.shape
    cir = _cv_resize_linear(cirrus.astype(np.float32), w, h)
    wavelength = np.linspace(400, 1000, 100)
    if c > 100:
        wavelength = np.linspace(400, 1000, c)
    top_k = max(int(h * w * top_percent / 100), 1)
    flat = x.reshape(c, -1)
    part = np.partition(flat, -top_k, axis=1)[:, -top_k:]
    atmos = part.mean(axis=1)

    t1 = 1 - omega * cir
    t1 = np.where(t1 <= 0, 1e-10, t1)
    log_t1 = np.log(t1)

    lam_ratio = (wavelength[0] / wavelength[:c]) ** gamma
    trans = np.exp(lam_ratio[:, None, None] * log_t1[None])
    hazy = x * trans + atmos[:, None, None] * (1 - trans)
    return hazy.astype(np.float32)


def default_cirrus(h: int = 512, w: int = 512, seed: int = 7) -> np.ndarray:
    """Synthetic smooth cirrus template in [0, 1] for environments without the
    reference's haze .mat assets: band-limited Gaussian random field."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((h // 16, w // 16))
    big = _cv_resize_cubic(base, w, h)
    big = (big - big.min()) / (big.max() - big.min() + 1e-12)
    return big.astype(np.float32)


def sd_cassi(x: np.ndarray, mask: np.ndarray, step: int = 2) -> np.ndarray:
    """SD-CASSI snapshot-compressive measurement simulation
    (reference: degradation_utils.py:202-225): modulate by a coded aperture,
    shear bands by `step` columns, sum to a single measurement, then shear
    back into per-band crops and min-max normalize."""
    c, h, w = x.shape
    mod = x * mask[None]
    meas = np.zeros((h, w + (c - 1) * step), x.dtype)
    for i in range(c):
        meas[:, step * i : step * i + w] += mod[i]
    out = np.zeros_like(x)
    for i in range(c):
        out[i] = meas[:, step * i : step * i + w]
    out = (out - out.min()) / (out.max() - out.min())
    return out.astype(np.float32)
