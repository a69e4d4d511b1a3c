"""Offline dataset builders: .mat cube directories -> HSPS patch stores (a
copy of ``mp_hsir_tpu/data/builders.py``).

Counterparts of the reference's offline layer (utils/lmdb_patch.py:39-260,
utils/mat_data.py:18-344): multi-scale patchification (scales 1, 0.5, 0.25),
64x64 tiles, invalid-mask rejection, per-patch min-max normalization, and —
for the remote-sensing store — resampling every sensor to a common
100-band 400-1000 nm grid by linear interpolation
(lmdb_patch.py:159-201).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mp_hsir_tpu_torch.data.patch_store import PatchStoreWriter
from mp_hsir_tpu_torch.utils.image import load_mat_cube

# nominal wavelength ranges (nm) per remote-sensing sensor, used to place
# each dataset's bands on the common grid (the reference hard-codes these
# in its builder, lmdb_patch.py:159-193)
SENSOR_RANGES: Dict[str, Tuple[float, float]] = {
    "WDC": (400, 2400),
    "PaviaC": (430, 860),
    "PaviaU": (430, 860),
    "Houston": (364, 1046),
    "Chikusei": (343, 1018),
    "Xiongan": (400, 1000),
    "Eagle": (401, 999),
    "BerlinUrGrad": (455, 2447),
}

COMMON_GRID = np.linspace(400.0, 1000.0, 100)


def resample_to_common_grid(cube: np.ndarray, wl_range: Tuple[float, float]) -> np.ndarray:
    """Linearly interpolate a (C, H, W) cube whose bands span wl_range onto
    the common 100-band 400-1000 nm grid; out-of-range targets clamp to the
    nearest measured band. Vectorized over all target bands at once."""
    c = cube.shape[0]
    src = np.linspace(wl_range[0], wl_range[1], c)
    flat = cube.reshape(c, -1)
    j = np.clip(np.searchsorted(src, COMMON_GRID), 1, c - 1)
    t = (COMMON_GRID - src[j - 1]) / (src[j] - src[j - 1])
    t = np.clip(t, 0.0, 1.0)[:, None].astype(np.float32)  # clamps the ends
    out = flat[j - 1] * (1.0 - t) + flat[j] * t
    return out.astype(np.float32).reshape(len(COMMON_GRID), *cube.shape[1:])


def _iter_patches(
    cube: np.ndarray,
    patch: int,
    stride: int,
    scales: Sequence[float],
    mask: Optional[np.ndarray],
):
    """Multi-scale sliding patches with invalid-mask rejection and per-patch
    min-max normalization (roles of Data2Volume, image_utils.py:416-448).

    Matches the reference builder's geometry: cubes are cropped to
    128-multiples before patching (lmdb_patch.py:128-129) and downscales use
    scipy zoom's default cubic spline for data, order-0 for masks
    (lmdb_patch.py:58-59)."""
    from scipy.ndimage import zoom

    _, h0, w0 = cube.shape
    ch, cw = (h0 // 128) * 128, (w0 // 128) * 128
    if ch and cw:
        cube = cube[:, :ch, :cw]
        mask = mask[:ch, :cw] if mask is not None else None
    for s in scales:
        if s == 1.0:
            c_s, m_s = cube, mask
        else:
            c_s = zoom(cube, (1, s, s))  # default order=3 like the reference
            m_s = zoom(mask.astype(np.float32), (s, s), order=0) > 0.5 if mask is not None else None
        _, h, w = c_s.shape
        for y in range(0, h - patch + 1, stride):
            for x in range(0, w - patch + 1, stride):
                if m_s is not None and m_s[y : y + patch, x : x + patch].any():
                    continue
                p = c_s[:, y : y + patch, x : x + patch]
                lo, hi = p.min(), p.max()
                if hi - lo < 1e-8:
                    continue
                yield ((p - lo) / (hi - lo)).astype(np.float32)


def build_patch_store(
    mat_dir: str,
    out_dir: str,
    patch: int = 64,
    stride: int = 64,
    scales: Sequence[float] = (1.0, 0.5, 0.25),
    remote_sensing: bool = False,
    mat_key: str = "data",
    invalid_below: Optional[float] = None,
) -> int:
    """Build an HSPS store from every .mat cube in `mat_dir`.

    remote_sensing=True resamples each cube onto the common 100-band grid
    using the sensor range inferred from the file-name prefix. Returns the
    number of patches written."""
    n = 0
    files = sorted(f for f in os.listdir(mat_dir) if f.endswith(".mat"))
    with PatchStoreWriter(out_dir) as writer:
        for fname in files:
            try:
                cube = load_mat_cube(os.path.join(mat_dir, fname), key=mat_key)
            except Exception as e:  # per-file tolerance like the reference builder
                print(f"[builders] skipping {fname}: {e}")
                continue
            cube = np.asarray(cube, np.float32)
            mask = None
            if invalid_below is not None:
                mask = (cube <= invalid_below).all(axis=0)
            if remote_sensing:
                prefix = next((k for k in SENSOR_RANGES if fname.startswith(k)), None)
                rng = SENSOR_RANGES.get(prefix, (400.0, 1000.0))
                cube = resample_to_common_grid(cube, rng)
            for p in _iter_patches(cube, patch, stride, scales, mask):
                writer.add(p, fname)
                n += 1
    print(f"[builders] wrote {n} patches -> {out_dir}")
    return n


def make_train_test_split(
    mat_dir: str, test_list: Sequence[str]
) -> Tuple[List[str], List[str]]:
    """Split .mat files by an explicit test list (the role of the
    ICVL_{train,test}_list.txt files in the reference's data_dir)."""
    files = sorted(f for f in os.listdir(mat_dir) if f.endswith(".mat"))
    test = [f for f in files if f in set(test_list)]
    train = [f for f in files if f not in set(test_list)]
    return train, test
