"""Mode-0 evaluation data: directories of .mat cubes, degraded on the host
with a per-file seeded numpy Generator (copies of the parts of
``mp_hsir_tpu/data/eval_datasets.py``, ``degradations_np.py`` and
``utils/image.py`` that mode 0 needs)."""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Sequence

import numpy as np


def gaussian_noise_fixed(x: np.ndarray, rng: np.random.Generator, sigma: float) -> np.ndarray:
    """iid Gaussian noise of std sigma/255."""
    return (x + rng.standard_normal(x.shape) * (sigma / 255.0)).astype(np.float32)


def crop_to_multiple(img: np.ndarray, base: int = 64) -> np.ndarray:
    """Centre-crop (C, H, W) so H and W are multiples of ``base``."""
    _, h, w = img.shape
    ch, cw = h % base, w % base
    return img[:, ch // 2: h - ch + ch // 2, cw // 2: w - cw + cw // 2]


def load_mat_cube(path: str, key: str = "data") -> np.ndarray:
    """A float32 (C, H, W) cube from a MATLAB v5 .mat file; an HWC cube (last
    axis strictly smallest) is transposed, as the JAX package does."""
    import scipy.io as sio

    cube = np.asarray(sio.loadmat(path)[key], dtype=np.float32)
    if cube.ndim == 3 and cube.shape[2] < cube.shape[0] and cube.shape[2] < cube.shape[1]:
        cube = np.ascontiguousarray(cube.transpose(2, 0, 1))
    return cube


def save_false_color(cube: np.ndarray, bands: Sequence[int], path: str) -> None:
    """3-band false-colour PNG from a (C, H, W) or (B, C, H, W) cube in [0, 1]."""
    from PIL import Image

    if cube.ndim == 4:
        cube = cube[0]
    sel = np.clip(cube[list(bands)], 0.0, 1.0)
    rgb = (sel.transpose(1, 2, 0) * 255.0).round().astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(rgb).save(path)


def _list_cubes(test_dir: str) -> List[str]:
    return [os.path.join(test_dir, n) for n in sorted(os.listdir(test_dir)) if not n.startswith(".")]


class GaussianDenoiseDataset:
    """mode 0: fixed-sigma iid Gaussian noise (reference
    dataset_utils.py:277-312); item i is degraded with
    ``np.random.default_rng([seed, i])``."""

    def __init__(self, test_dir: str, sigma: float, seed: int = 2024, crop_base: int = 64):
        self.paths = _list_cubes(test_dir)
        self.sigma = sigma
        self.seed = seed
        self.crop_base = crop_base
        print(f"Total Test HSIs Ids : {len(self.paths)}")

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self) -> Iterator[Dict]:
        for i, path in enumerate(self.paths):
            clean = np.ascontiguousarray(crop_to_multiple(load_mat_cube(path), self.crop_base),
                                         np.float32)
            rng = np.random.default_rng([self.seed, i])
            yield {"name": os.path.basename(path).split(".")[0], "clean": clean,
                   "degraded": gaussian_noise_fixed(clean.copy(), rng, self.sigma)}
