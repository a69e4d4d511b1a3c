"""Evaluation datasets: the 13 per-mode test pipelines (counterpart of
``mp_hsir_tpu/data/eval_datasets.py``; reference utils/dataset_utils.py:
212-879) as seeded iterators over directories of .mat cubes.

Each item is a dict: ``name`` (str), ``degraded`` and ``clean`` (C, H, W)
float32, and ``mask`` for inpainting. Item ``i`` is degraded on the host with
``np.random.default_rng([cfg.seed, i])``, so an item does not depend on the
order in which the others were read.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from mp_hsir_tpu_torch.config import EvalConfig
from mp_hsir_tpu_torch.data import degradations_np as DN
from mp_hsir_tpu_torch.utils.image import crop_to_multiple, load_mat_cube


def _list_cubes(test_dir: str) -> List[str]:
    names = sorted(os.listdir(test_dir))
    return [os.path.join(test_dir, n) for n in names if not n.startswith(".")]


class EvalDataset:
    """Base: iterate the clean cubes, synthesise one degradation per item."""

    def __init__(self, cfg: EvalConfig, crop_base: int = 64):
        self.cfg = cfg
        self.paths = _list_cubes(cfg.test_dir)
        self.crop_base = crop_base
        print(f"Total Test HSIs Ids : {len(self.paths)}")

    def __len__(self) -> int:
        return len(self.paths)

    def _rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng([self.cfg.seed, idx])

    def _clean(self, idx: int) -> Tuple[np.ndarray, str]:
        path = self.paths[idx]
        cube = crop_to_multiple(load_mat_cube(path), self.crop_base)
        return np.ascontiguousarray(cube, np.float32), os.path.basename(path).split(".")[0]

    def synthesize(self, clean: np.ndarray, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[Dict]:
        for i in range(len(self)):
            clean, name = self._clean(i)
            item = self.synthesize(clean.copy(), self._rng(i))
            item.update(name=name, clean=clean)
            yield item


class GaussianDenoiseDataset(EvalDataset):
    """mode 0: fixed-sigma iid Gaussian (dataset_utils.py:277-312)."""

    def synthesize(self, clean, rng):
        return {"degraded": DN.gaussian_noise_fixed(clean, rng, self.cfg.gaussian_noise_sigma)}


class GaussianDenoiseInidDataset(EvalDataset):
    """mode 1: per-band sigma from a set (dataset_utils.py:315-348)."""

    def synthesize(self, clean, rng):
        return {"degraded": DN.gaussian_noise_non_iid(clean, rng, self.cfg.gaussian_noise_sigmas)}


class StripeDenoiseDataset(EvalDataset):
    """mode 2: non-iid Gaussian + stripes (dataset_utils.py:351-406)."""

    def synthesize(self, clean, rng):
        noisy = DN.gaussian_noise_non_iid(clean, rng, (10, 30, 50, 70))
        return {"degraded": DN.stripe_noise(noisy, rng, self.cfg.stripe_noise_ratio)}


class DeadlineDenoiseDataset(EvalDataset):
    """mode 3: non-iid Gaussian + dead columns (dataset_utils.py:408-466)."""

    def synthesize(self, clean, rng):
        noisy = DN.gaussian_noise_non_iid(clean, rng, (10, 30, 50, 70))
        return {"degraded": DN.deadline_noise(noisy, rng, self.cfg.deadline_noise_ratio)}


class ImpulseDenoiseDataset(EvalDataset):
    """mode 4: non-iid Gaussian + salt and pepper at an amount drawn from
    ``impulse_noise_ratio`` (dataset_utils.py:468-522)."""

    def synthesize(self, clean, rng):
        noisy = DN.gaussian_noise_non_iid(clean, rng, (10, 30, 50, 70))
        amount = rng.choice(np.asarray(self.cfg.impulse_noise_ratio))
        return {"degraded": DN.impulse_noise(noisy, rng, float(amount))}


class ImpulseDenoiseInidDataset(EvalDataset):
    """Impulse noise alone, a random amount per band on a third of the bands
    (dataset_utils.py:524-569; no mode selects it, as in the reference)."""

    def synthesize(self, clean, rng):
        out = clean.copy()
        b, h, w = clean.shape
        for bi in rng.permutation(b)[: int(np.floor(b / 3))]:
            amount = float(rng.choice([0.1, 0.3, 0.5, 0.7]))
            flipped = rng.random((h, w)) < amount
            salted = rng.random((h, w)) < 0.5
            out[bi][flipped & salted] = 1.0
            out[bi][flipped & ~salted] = 0.0
        return {"degraded": out}


class GaussianDeblurDataset(EvalDataset):
    """mode 5: Gaussian blur of size ``gaussian_blur_radius``
    (dataset_utils.py:571-622)."""

    def synthesize(self, clean, rng):
        kernel = DN.gaussian_blur_kernel(self.cfg.gaussian_blur_radius)
        return {"degraded": DN.apply_blur(clean, kernel)}


class MotionDeblurDataset(EvalDataset):
    """mode 6: motion blur (kernel size, angle) (dataset_utils.py:624-678)."""

    def synthesize(self, clean, rng):
        return {"degraded": DN.apply_blur(clean, DN.motion_blur_kernel(*self.cfg.motion_blur))}


class SuperResolutionDataset(EvalDataset):
    """mode 7: bicubic down, pixel replication back (dataset_utils.py:681-725)."""

    def synthesize(self, clean, rng):
        return {"degraded": DN.sr_degrade(clean, self.cfg.downsample_factor)}


class InpaintDataset(EvalDataset):
    """mode 8: random pixel mask, also yielded (dataset_utils.py:728-769)."""

    def synthesize(self, clean, rng):
        degraded, mask = DN.random_mask(clean, rng, self.cfg.mask_ratio)
        return {"degraded": degraded, "mask": mask.astype(np.float32)}


class DehazeDataset(EvalDataset):
    """mode 9: physical cirrus haze (dataset_utils.py:771-840), from the .mat
    templates (key ``haze``) of ``haze_dir`` where it holds any, else the
    synthetic default template."""

    def __init__(self, cfg: EvalConfig, haze_dir: Optional[str] = None):
        super().__init__(cfg)
        self.templates: List[np.ndarray] = []
        if haze_dir and os.path.isdir(haze_dir):
            for p in _list_cubes(haze_dir):
                try:
                    self.templates.append(load_mat_cube(p, key="haze"))
                except (KeyError, ValueError, OSError, NotImplementedError):
                    pass  # not a haze template: skipped, as the JAX dataset skips it
        if not self.templates:
            self.templates = [DN.default_cirrus()]

    def synthesize(self, clean, rng):
        cir = self.templates[int(rng.integers(0, len(self.templates)))]
        return {"degraded": DN.simulate_haze(clean, cir, omega=self.cfg.haze_omega)}


class BandmisDataset(EvalDataset):
    """mode 10: a fraction of the bands set to zero (dataset_utils.py:842-879)."""

    def synthesize(self, clean, rng):
        return {"degraded": DN.band_loss(clean, rng, self.cfg.bandmis_ratio)}


class PoissonDenoiseDataset(EvalDataset):
    """mode 11 (zero-shot): Poisson noise (dataset_utils.py:243-275)."""

    def synthesize(self, clean, rng):
        return {"degraded": DN.poisson_noise(clean, rng, self.cfg.poisson_scale)}


class RealDegradDataset:
    """mode 12: real degraded cubes in ``test_degrad_dir`` paired by name
    order with the clean ones in ``test_dir`` (dataset_utils.py:212-239)."""

    def __init__(self, cfg: EvalConfig):
        if not cfg.test_degrad_dir:
            raise SystemExit("mode 12 pairs each clean cube with a real degraded one: "
                             "pass --test_degrad_dir DIR")
        self.clean_paths = _list_cubes(cfg.test_dir)
        self.noisy_paths = _list_cubes(cfg.test_degrad_dir)
        print(f"Total Test HSIs Ids : {len(self.clean_paths)}")

    def __len__(self) -> int:
        return len(self.clean_paths)

    def __iter__(self) -> Iterator[Dict]:
        def cube(path):
            return np.ascontiguousarray(crop_to_multiple(load_mat_cube(path), 64), np.float32)

        for cp, dp in zip(self.clean_paths, self.noisy_paths):
            yield {"name": os.path.basename(cp).split(".")[0], "clean": cube(cp),
                   "degraded": cube(dp)}


MODE_DATASETS = {
    0: GaussianDenoiseDataset,
    1: GaussianDenoiseInidDataset,
    2: StripeDenoiseDataset,
    3: DeadlineDenoiseDataset,
    4: ImpulseDenoiseDataset,
    5: GaussianDeblurDataset,
    6: MotionDeblurDataset,
    7: SuperResolutionDataset,
    8: InpaintDataset,
    9: DehazeDataset,
    10: BandmisDataset,
    11: PoissonDenoiseDataset,
    12: RealDegradDataset,
}
