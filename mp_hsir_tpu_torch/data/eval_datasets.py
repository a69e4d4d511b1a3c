"""Mode-0 evaluation data: directories of .mat cubes, degraded on the host
with a per-file seeded numpy Generator (the mode-0 part of
``mp_hsir_tpu/data/eval_datasets.py``)."""

from __future__ import annotations

import os
from typing import Dict, Iterator, List

import numpy as np

from mp_hsir_tpu_torch.data.degradations_np import gaussian_noise_fixed
from mp_hsir_tpu_torch.utils.image import crop_to_multiple, load_mat_cube


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
