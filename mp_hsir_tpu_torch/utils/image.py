"""Host-side image utilities (crop, band interpolation, png dump, .mat I/O,
normalisers, spectral low-rank factorisations): a copy of
``mp_hsir_tpu/utils/image.py`` (numpy only), so the port imports nothing of
the JAX package.

Counterparts of the reference's utils/image_utils.py:58-74 (crop_img),
:597-618 (interpolate_bands) and utils/image_io.py:156 (false-color png
saver).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def crop_to_multiple(img: np.ndarray, base: int = 64) -> np.ndarray:
    """Center-crop (C, H, W) or (H, W) so both spatial dims are multiples of
    `base` (reference crop_img)."""
    if img.ndim == 2:
        img = img[None]
        squeeze = True
    else:
        squeeze = False
    _, h, w = img.shape
    ch, cw = h % base, w % base
    out = img[:, ch // 2 : h - ch + ch // 2, cw // 2 : w - cw + cw // 2]
    return out[0] if squeeze else out


def interpolate_bands(cube: np.ndarray, target_bands: int) -> np.ndarray:
    """Resample a (C, H, W) cube to `target_bands` via linear interpolation
    along the band axis (role of reference interpolate_bands, which places
    original bands on a rounded grid; we interpolate on a uniform grid —
    equivalent signal, no zero-filled gaps)."""
    c = cube.shape[0]
    if c == target_bands:
        return cube.astype(np.float32)
    src = np.linspace(0.0, 1.0, c)
    dst = np.linspace(0.0, 1.0, target_bands)
    idx = np.searchsorted(src, dst, side="right") - 1
    idx = np.clip(idx, 0, c - 2)
    frac = (dst - src[idx]) / (src[idx + 1] - src[idx])
    out = cube[idx] * (1 - frac)[:, None, None] + cube[idx + 1] * frac[:, None, None]
    return out.astype(np.float32)


def minmax_normalize(a: np.ndarray) -> np.ndarray:
    lo, hi = float(a.min()), float(a.max())
    return ((a - lo) / (hi - lo + 1e-12)).astype(np.float32)


def save_false_color(cube: np.ndarray, bands: Sequence[int], path: str) -> None:
    """Write a 3-band false-color PNG from a (C, H, W) or (B, C, H, W) cube
    in [0, 1] (role of reference save_image_tensor; reference uses bands
    [27, 15, 9], test.py:565)."""
    from PIL import Image

    if cube.ndim == 4:
        cube = cube[0]
    sel = np.clip(cube[list(bands)], 0.0, 1.0)
    rgb = (sel.transpose(1, 2, 0) * 255.0).round().astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(rgb).save(path)


def load_mat_cube(path: str, key: str = "data") -> np.ndarray:
    """Load a float32 cube from a MATLAB .mat file (v5 via scipy, v7.3 via
    h5py if available) and return it as (C, H, W).

    Dataset .mat artifacts store cubes HWC (MATLAB convention — both the
    reference's builders and data/mat_builders.py write that layout, and the
    reference loaders transpose(2, 0, 1) on load, lmdb_patch.py:92,185).
    Orientation is detected: when the LAST axis is strictly smaller than
    both others it is the band axis (HWC) and the cube is transposed;
    otherwise it is assumed already (C, H, W). Ambiguous cubes whose band
    count reaches their spatial size are treated as (C, H, W)."""
    import scipy.io as sio

    try:
        cube = np.asarray(sio.loadmat(path)[key], dtype=np.float32)
    except NotImplementedError:
        import h5py

        # MATLAB v7.3 stores column-major: h5py exposes the array with
        # REVERSED axes ((H, W, C) on disk reads as (C, W, H)) — undo that
        # before the orientation heuristic
        with h5py.File(path, "r") as f:
            cube = np.asarray(f[key], dtype=np.float32)
        if cube.ndim == 3:
            cube = np.ascontiguousarray(cube.transpose(2, 1, 0))
    if cube.ndim == 3 and cube.shape[2] < cube.shape[0] and cube.shape[2] < cube.shape[1]:
        cube = np.ascontiguousarray(cube.transpose(2, 0, 1))  # HWC -> CHW
    return cube


def save_mat_cube(path: str, cube: np.ndarray, key: str = "data") -> None:
    import scipy.io as sio

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sio.savemat(path, {key: cube.astype(np.float32)})


def crop_center(img: np.ndarray, cropx: int, cropy: int) -> np.ndarray:
    """Center crop of a (C, H, W) cube (reference image_utils.py:398-402;
    note the reference's (cropx, cropy) naming is (W, H))."""
    _, y, x = img.shape
    startx = x // 2 - (cropx // 2)
    starty = y // 2 - (cropy // 2)
    return img[:, starty:starty + cropy, startx:startx + cropx]


def rand_crop(img: np.ndarray, cropx: int, cropy: int, rng=None) -> np.ndarray:
    """Random crop of a (C, H, W) cube (reference image_utils.py:409-413),
    key-driven: pass a np.random.Generator for reproducibility."""
    rng = rng or np.random.default_rng()
    _, y, x = img.shape
    x1 = int(rng.integers(0, x - cropx + 1))
    y1 = int(rng.integers(0, y - cropy + 1))
    return img[:, y1:y1 + cropy, x1:x1 + cropx]


def data2volume(data: np.ndarray, mask, ksizes, strides) -> np.ndarray:
    """Sliding-window patch extraction over a (C, H, W) cube keeping only
    patches whose mask region is fully valid, each min-max normalized
    (reference image_utils.py:416-448 Data2Volume)."""
    from itertools import product

    dshape = data.shape
    valid = []
    args = [range(0, dshape[i] - ksizes[i] + 1, strides[i]) for i in range(len(ksizes))]
    for s in product(*args):
        sl = tuple(slice(s[i], s[i] + ksizes[i]) for i in range(len(ksizes)))
        patch = data[sl]
        pmask = (mask[sl[1], sl[2]] if mask is not None
                 else np.zeros(patch.shape[1:], dtype=bool))
        if not np.any(pmask):
            pmin, pmax = np.min(patch), np.max(patch)
            if pmax - pmin < 1e-8:
                continue  # constant patch: normalizing would emit NaNs
            valid.append((patch - pmin) / (pmax - pmin))
    if valid:
        return np.stack(valid)
    return np.zeros((0,) + tuple(ksizes), data.dtype)


class BandMinMaxQuantile:
    """Per-band quantile normalizer fit over a set of (C, H, W) cubes with
    optional invalid-pixel masks; clamps to the [low, up] percentiles and
    rescales (reference image_utils.py:356-396 BandMinMaxQuantileStateful,
    torch-free)."""

    def __init__(self, low: float = 0.02, up: float = 0.98, epsilon: float = 0.001):
        self.low, self.up, self.epsilon = low, up, epsilon
        self.q: np.ndarray | None = None  # (2, C, 1, 1)

    def fit(self, imgs, masks=None) -> "BandMinMaxQuantile":
        cols = []
        for i, img in enumerate(imgs):
            m = masks[i] if masks is not None else None
            valid = img[:, ~m] if m is not None else img.reshape(img.shape[0], -1)
            if valid.size:
                cols.append(valid.reshape(img.shape[0], -1))
        x = np.concatenate(cols, axis=1)
        q = np.percentile(x, [100 * self.low, 100 * self.up], axis=1)  # (2, C)
        self.q = q.astype(np.float32)[:, :, None, None]
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        lo, hi = self.q[0], self.q[1]
        x = np.clip(x, lo, hi)
        return (x - lo) / (self.epsilon + (hi - lo))


def qr_rank(A: np.ndarray, f: float, k: int):
    """Rank-k column-pivoted QR: returns (Q, R, p) with the k most pivotal
    columns leading. Role of the reference's strong rank-revealing QR
    (image_utils.py:467-573 QR_rank); the srrqr extra-swap loop (parameter
    f) is collapsed to scipy's standard column pivoting, which selects the
    same leading columns for well-conditioned HSI spectra."""
    from scipy.linalg import qr

    m, n = A.shape
    k = min(k, m, n)
    Q, R, p = qr(A, mode="economic", pivoting=True)
    return Q[:, :k], R[:k], p


def ls_rank(data: np.ndarray, rank: int):
    """Least-squares spectral low-rank factorization: pick `rank` evenly
    spaced bands as the abundance maps A and solve for the mixing matrix E
    minimizing ||data - E A|| (reference image_utils.py:575-587 LS_rank).
    Returns (A (rank, H, W), E (C, rank))."""
    C, H, W = data.shape[-3], data.shape[-2], data.shape[-1]
    idx = np.linspace(0, C - 1, rank, dtype=int)
    A = np.take(data, idx, axis=0).reshape(rank, H * W)
    t1 = A @ A.T
    t2 = data.reshape(C, H * W) @ A.T
    E = t2 @ np.linalg.inv(t1)
    return A.reshape(rank, H, W), E.reshape(C, rank)


def svd_rank(data: np.ndarray, rank: int):
    """SVD spectral low-rank factorization (reference image_utils.py:587-596
    svd_rank). Returns (A (rank, H, W), E (C, rank)) with data ~= E @ A."""
    C, H, W = data.shape[-3], data.shape[-2], data.shape[-1]
    flat = data.reshape(C, H * W)
    U, _, _ = np.linalg.svd(flat, full_matrices=False)
    E = U[:, :rank]
    A = (E.T @ flat).reshape(rank, H, W)
    return A, E
