"""Batched on-device train-time degradation and augmentation (counterpart of
``mp_hsir_tpu/ops/pipeline_degrade.py``; intensity tables of the reference's
utils/dataset_utils.py:112,117).

The JAX package vmaps a ``lax.switch`` over the batch, which computes every
branch for every sample. Here each branch runs once, on the samples whose
task it is:

* the host draws the task ids and every discrete choice (complexN's noise
  type and impulse amount, the blur kernel, the SR factor, the inpaint
  ratio, the band-miss rate, the haze omega and template, the augmentation
  mode) from numpy;
* the batch is ordered by (task, choice, choice) on the host, so that each
  group is a contiguous slice with python-scalar parameters; the order
  travels to the device with the batch, and the result is scattered back;
* the device draws only the dense fields (noise, masks, column ranks) from
  one ``torch.Generator``.

Nothing reads the device back, so the pipeline's producer and the train step
overlap. Augmentation is a per-sample gather of the pixels through one of 8
index maps (square patches, as the JAX switch requires).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mp_hsir_tpu_torch import upload
from mp_hsir_tpu_torch.data.degradations_np import (
    circle_blur_kernel,
    gaussian_blur_kernel,
    motion_blur_kernel,
)
from mp_hsir_tpu_torch.ops import degradations as D

NATURAL_DE_TYPES = ("gaussianN", "complexN", "blur", "sr", "inpaint", "bandmiss")
REMOTE_DE_TYPES = ("gaussianN", "complexN", "blur", "sr", "inpaint", "haze", "bandmiss")

TABLES = {
    "natural_scene": {
        "gaussianN": dict(sigma_range=(30, 70)),
        "complexN": dict(sigmas=(10, 30, 50, 70), deadline=(0.05, 0.15),
                         impulse=(0.1, 0.3, 0.5, 0.7), stripe=(0.05, 0.15)),
        "blur": dict(ksizes=(9, 15, 21)),
        "sr": dict(factors=(2, 4, 8)),
        "inpaint": dict(ratios=(0.7, 0.8, 0.9)),
        "bandmiss": dict(rates=(0.1, 0.2, 0.3)),
        "motion_blur": dict(kernels=((15, 45),)),
        "cassi": dict(),
        # standalone variants of the classifier pipeline (reference
        # utils/dataset_utils.py:160), applied to the clean patch
        "deadline": dict(amount=(0.05, 0.15)),
        "stripe": dict(amount=(0.05, 0.15)),
        "impulse": dict(amounts=(0.1, 0.3, 0.5, 0.7)),
    },
    "remote_sensing": {
        "gaussianN": dict(sigma_range=(30, 70)),
        "complexN": dict(sigmas=(10, 30, 50, 70), deadline=(0.05, 0.15),
                         impulse=(0.1, 0.3, 0.5, 0.7), stripe=(0.05, 0.15)),
        "blur": dict(ksizes=(7, 11, 15)),
        "sr": dict(factors=(2, 4, 8)),
        "inpaint": dict(ratios=(0.7, 0.8, 0.9)),
        "haze": dict(omegas=(0.5, 0.75, 1.0)),
        "bandmiss": dict(rates=(0.1, 0.2, 0.3)),
        "circle_blur": dict(ksizes=(9,)),
        "poissonN": dict(scales=(10.0,)),
        "deadline": dict(amount=(0.05, 0.15)),
        "stripe": dict(amount=(0.05, 0.15)),
        "impulse": dict(amounts=(0.1, 0.3, 0.5, 0.7)),
    },
}

# the reference's classifier dataset blurs with ksizes (9, 15, 21) for both
# data types (utils/dataset_utils.py:160,166); its restoration set narrows
# remote sensing to (7, 11, 15) (:117)
CLASSIFIER_TABLE_OVERRIDES = {
    "natural_scene": {},
    "remote_sensing": {"blur": dict(ksizes=(9, 15, 21))},
}

CLASSIFIER_DE_TYPES = {
    "natural_scene": ("gaussianN", "deadline", "impulse", "stripe", "blur", "sr", "inpaint"),
    "remote_sensing": ("gaussianN", "deadline", "impulse", "stripe", "blur", "sr", "inpaint", "haze"),
}


def _pad_bank(kernels: Sequence[np.ndarray]) -> np.ndarray:
    """Square kernels zero-padded to the largest size and stacked."""
    kmax = max(k.shape[0] for k in kernels)
    bank = np.zeros((len(kernels), kmax, kmax), np.float32)
    for i, k in enumerate(kernels):
        pad = (kmax - k.shape[0]) // 2
        bank[i, pad: pad + k.shape[0], pad: pad + k.shape[0]] = k
    return bank


def _kernel_bank(ksizes: Sequence[int], maker) -> np.ndarray:
    """The JAX package's kernel bank (a branch here crops its kernel back out
    of it, so each group convolves with the kernel's own size)."""
    return _pad_bank([maker(k) for k in ksizes])


def jax_linear_resize(a: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``jax.image.resize(a, a.shape[:-2] + out_hw, "linear")`` over the last
    two axes of a float32 array: the triangle kernel, widened by the scale
    when downsampling (antialiased), weights normalised per output and zeroed
    for samples outside the input, in float32 as JAX computes them."""
    a = np.asarray(a, np.float32)
    for axis, n_out in ((-2, out_hw[0]), (-1, out_hw[1])):
        n_in = a.shape[axis]
        if n_in == n_out:
            continue
        inv = np.float32(1.0 / (n_out / n_in))
        kscale = np.maximum(inv, np.float32(1.0))
        f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.0) \
            - np.float32(0.5)
        x = np.abs(f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kscale
        w = np.maximum(np.float32(0), np.float32(1) - np.abs(x))
        tot = w.sum(axis=0, keepdims=True)
        w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                     w / np.where(tot != 0, tot, np.float32(1)), np.float32(0))
        w = np.where(((f >= -0.5) & (f <= n_in - 0.5))[None, :], w, np.float32(0))
        a = np.moveaxis(np.tensordot(np.moveaxis(a, axis, -1), w.astype(np.float32), axes=1),
                        -1, axis).astype(np.float32)
    return a


@dataclasses.dataclass
class Branch:
    """One degradation type. ``n_sub`` options for the first host-drawn
    choice and, per option, ``n_sub2[sub]`` for the second (one where
    ``n_sub2`` is empty); ``draw(gen, x,
    sub, sub2)`` makes the dense device draws of a group (n, C, H, W),
    ``apply(x, draws, sub, sub2)`` the deterministic rest."""

    name: str
    draw: Callable
    apply: Callable
    n_sub: int = 1
    n_sub2: Tuple[int, ...] = ()

    def __call__(self, gen: torch.Generator, x: torch.Tensor, sub: int = 0,
                 sub2: int = 0) -> torch.Tensor:
        return self.apply(x, self.draw(gen, x, sub, sub2), sub, sub2)


def _blur_branch(name: str, bank: np.ndarray, ksizes: Sequence[int]) -> Branch:
    kmax = bank.shape[-1]
    banks = {}

    def kernel(sub, device):
        if device not in banks:
            banks[device] = upload(bank, device)
        p = (kmax - ksizes[sub]) // 2
        return banks[device][sub, p: p + ksizes[sub], p: p + ksizes[sub]]

    return Branch(name, lambda gen, x, sub, sub2: (),
                  lambda x, d, sub, sub2: D.apply_blur(x, kernel(sub, x.device)),
                  n_sub=len(ksizes))


def _complex_draw(cfg):
    def draw(gen, x, sub, sub2):
        noise = D.gaussian_non_iid_draw(gen, x, cfg["sigmas"])
        if sub == 0:
            return noise + D.deadline_draw(gen, x, cfg["deadline"])
        if sub == 1:
            return noise + D.impulse_draw(gen, x, cfg["impulse"][sub2])
        return noise + D.stripe_draw(gen, x, cfg["stripe"])
    return draw


def _complex_apply(x, d, sub, sub2):
    y = D.gaussian_apply(x, d[0], d[1])
    return (D.deadline_apply, D.impulse_apply, D.stripe_apply)[sub](y, *d[2:])


class Degrader:
    """``make_degrader``'s result: the branches of ``de_types`` in task-id
    order. ``choices(de_ids, u)`` maps host uniforms (B, 2) to each sample's
    (sub, sub2); ``plan`` orders a batch into groups; calling it degrades a
    batch (B, C, H, W) on its device."""

    def __init__(self, branches: List[Branch]):
        self.branches = branches

    def choices(self, de_ids: np.ndarray, u: np.ndarray) -> np.ndarray:
        out = np.zeros((len(de_ids), 2), np.int64)
        for j, t in enumerate(de_ids):
            br = self.branches[int(t)]
            sub = min(int(u[j, 0] * br.n_sub), br.n_sub - 1)
            n2 = br.n_sub2[sub] if br.n_sub2 else 1
            out[j] = sub, min(int(u[j, 1] * n2), n2 - 1)
        return out

    @staticmethod
    def plan(de_ids: np.ndarray, choices: np.ndarray):
        """(order, runs): the batch sorted by (task, sub, sub2) (stable), and
        the contiguous runs (start, end, task, sub, sub2) of that order."""
        order = np.lexsort((choices[:, 1], choices[:, 0], de_ids)).astype(np.int64)
        keys = np.stack([de_ids[order], choices[order, 0], choices[order, 1]], 1)
        runs, start = [], 0
        for j in range(1, len(order) + 1):
            if j == len(order) or (keys[j] != keys[start]).any():
                runs.append((start, j) + tuple(int(v) for v in keys[start]))
                start = j
        return order, runs

    def run(self, gen: torch.Generator, clean: torch.Tensor, order: torch.Tensor,
            runs) -> torch.Tensor:
        """Degrade ``clean`` (B, C, H, W) float32 group by group; ``order`` is
        ``plan``'s order on the device."""
        xs = clean.index_select(0, order)
        out = torch.empty_like(xs)
        for a, b, t, sub, sub2 in runs:
            out[a:b] = self.branches[t](gen, xs[a:b], sub, sub2)
        return torch.empty_like(out).index_copy_(0, order, out)

    def __call__(self, gen: torch.Generator, clean: torch.Tensor, de_ids: np.ndarray,
                 choices: np.ndarray) -> torch.Tensor:
        order, runs = self.plan(np.asarray(de_ids), np.asarray(choices))
        return self.run(gen, clean, upload(order, clean.device), runs)


def make_degrader(de_types: Sequence[str], data_type: str,
                  cirrus_bank: Optional[np.ndarray] = None,
                  table_overrides: Optional[dict] = None) -> Degrader:
    """The branches of ``de_types`` under the data type's intensity table."""
    table = dict(TABLES[data_type])
    table.update(table_overrides or {})
    branches = []
    for t in de_types:
        cfg = table[t]
        if t == "gaussianN":
            br = Branch(t, lambda gen, x, sub, sub2, _c=cfg: D.gaussian_iid_draw(
                gen, x, _c["sigma_range"]), lambda x, d, sub, sub2: D.gaussian_apply(x, *d))
        elif t == "complexN":
            br = Branch(t, _complex_draw(cfg), _complex_apply, n_sub=3,
                        n_sub2=(1, len(cfg["impulse"]), 1))
        elif t == "blur":
            br = _blur_branch(t, _kernel_bank(cfg["ksizes"], gaussian_blur_kernel), cfg["ksizes"])
        elif t == "circle_blur":
            br = _blur_branch(t, _kernel_bank(cfg["ksizes"], circle_blur_kernel), cfg["ksizes"])
        elif t == "motion_blur":
            kernels = [motion_blur_kernel(k, a) for (k, a) in cfg["kernels"]]
            br = _blur_branch(t, _pad_bank(kernels), [k.shape[0] for k in kernels])
        elif t == "sr":
            br = Branch(t, lambda gen, x, sub, sub2: (),
                        lambda x, d, sub, sub2, _f=cfg["factors"]: D.sr_degrade(x, _f[sub]),
                        n_sub=len(cfg["factors"]))
        elif t == "inpaint":
            br = Branch(t, lambda gen, x, sub, sub2, _r=cfg["ratios"]: D.random_mask_draw(
                gen, x, float(np.float32(_r[sub]))), lambda x, d, sub, sub2: D.mask_apply(x, *d),
                n_sub=len(cfg["ratios"]))
        elif t == "bandmiss":
            br = Branch(t, lambda gen, x, sub, sub2, _r=cfg["rates"]: D.band_loss_draw(
                gen, x, int(np.floor(np.float32(_r[sub]) * np.float32(x.shape[1])))),
                lambda x, d, sub, sub2: D.band_apply(x, *d), n_sub=len(cfg["rates"]))
        elif t == "haze":
            if cirrus_bank is None:
                raise ValueError("haze degradation needs a cirrus template bank")
            br = _haze_branch(cfg["omegas"], np.asarray(cirrus_bank, np.float32))
        elif t == "poissonN":
            scale = float(cfg["scales"][0])
            br = Branch(t, lambda gen, x, sub, sub2, _s=scale: D.poisson_draw(gen, x, _s),
                        lambda x, d, sub, sub2, _s=scale: D.poisson_apply(d[0], _s))
        elif t == "deadline":
            br = Branch(t, lambda gen, x, sub, sub2, _c=cfg: D.deadline_draw(gen, x, _c["amount"]),
                        lambda x, d, sub, sub2: D.deadline_apply(x, *d))
        elif t == "stripe":
            br = Branch(t, lambda gen, x, sub, sub2, _c=cfg: D.stripe_draw(gen, x, _c["amount"]),
                        lambda x, d, sub, sub2: D.stripe_apply(x, *d))
        elif t == "impulse":
            br = Branch(t, lambda gen, x, sub, sub2, _a=cfg["amounts"]: D.impulse_draw(
                gen, x, float(np.float32(_a[sub]))), lambda x, d, sub, sub2: D.impulse_apply(x, *d),
                n_sub=len(cfg["amounts"]))
        elif t == "cassi":
            # a random binary mask per sample stands in for the reference's
            # .mat mask bank (degradation_utils.py:202-225)
            br = Branch(t, lambda gen, x, sub, sub2: D.cassi_draw(gen, x),
                        lambda x, d, sub, sub2: D.sd_cassi(x, d[0]))
        else:
            raise ValueError(f"unknown degradation type {t}")
        branches.append(br)
    return Degrader(branches)


def _haze_branch(omegas: Sequence[float], bank: np.ndarray) -> Branch:
    """sub: the omega, sub2: the template. A template whose size is not the
    patch's is resized as the JAX branch resizes it (``jax.image.resize``
    linear), once per patch size."""
    cache = {}

    def template(sub2, x):
        key = (x.device, tuple(x.shape[-2:]))
        if key not in cache:
            cb = bank if bank.shape[1:] == key[1] else jax_linear_resize(bank, key[1])
            cache[key] = upload(cb, x.device)
        return cache[key][sub2]

    return Branch("haze", lambda gen, x, sub, sub2: (),
                  lambda x, d, sub, sub2: D.simulate_haze(
                      x, template(sub2, x), float(np.float32(omegas[sub]))),
                  n_sub=len(omegas), n_sub2=(bank.shape[0],) * len(omegas))


# ---------------------------------------------------------------------------
# 8-way flip / rotation augmentation (reference utils/image_utils.py:141-191)
# ---------------------------------------------------------------------------

def _augment_one(x: torch.Tensor, mode: int) -> torch.Tensor:
    """(..., H, W); mode 0..7 as the reference's data_augmentation (the flip
    is its ``flipud``, on H; rotations counter-clockwise in the (H, W) plane)."""
    y = torch.rot90(x, mode // 2, (-2, -1)) if mode >= 2 else x
    return y.flip(-2) if mode % 2 else y


@lru_cache(maxsize=16)
def _augment_maps(h: int, w: int, device: torch.device) -> torch.Tensor:
    """(8, H W) int64: the source pixel of each output pixel per mode, built
    on the device."""
    grid = torch.arange(h * w, device=device).view(h, w)
    return torch.stack([_augment_one(grid, m).reshape(-1) for m in range(8)])


def augment(x: torch.Tensor, modes: torch.Tensor) -> torch.Tensor:
    """Each sample of (B, C, H, W) (H = W) through its mode (B,) on the device."""
    b, c, h, w = x.shape
    idx = _augment_maps(h, w, x.device)[modes]
    return x.reshape(b, c, h * w).gather(2, idx[:, None, :].expand(b, c, h * w)).view(b, c, h, w)


class BatchDegrader:
    """``make_batch_degrader``'s result. ``host_draws(rng, de_ids)`` draws
    each sample's choices and augmentation mode (1..7: the reference draws
    randint(1, 7) and never the identity, utils/image_utils.py:186-191);
    ``run`` degrades and augments a batch on the device."""

    def __init__(self, degrader: Degrader):
        self.degrader = degrader

    def host_draws(self, rng: np.random.Generator, de_ids: np.ndarray):
        """(choices (B, 2), modes (B,), order (B,), runs)."""
        choices = self.degrader.choices(de_ids, rng.random((len(de_ids), 2)))
        modes = rng.integers(1, 8, size=len(de_ids))
        order, runs = self.degrader.plan(de_ids, choices)
        return choices, modes, order, runs

    def run(self, gen: torch.Generator, clean: torch.Tensor, order: torch.Tensor,
            modes: torch.Tensor, runs):
        """(degraded, clean), both augmented by the same per-sample mode."""
        degraded = self.degrader.run(gen, clean, order, runs)
        return augment(degraded, modes), augment(clean, modes)

    def __call__(self, gen: torch.Generator, clean: torch.Tensor, de_ids: np.ndarray,
                 rng: np.random.Generator):
        _, modes, order, runs = self.host_draws(rng, np.asarray(de_ids))
        dev = clean.device
        return self.run(gen, clean, upload(order, dev), upload(modes, dev), runs)


def make_batch_degrader(de_types: Sequence[str], data_type: str,
                        cirrus_bank: Optional[np.ndarray] = None,
                        table_overrides: Optional[dict] = None) -> BatchDegrader:
    return BatchDegrader(make_degrader(de_types, data_type, cirrus_bank, table_overrides))
