"""Typed configuration (mirrors ``mp_hsir_tpu/config.py``: ModelConfig, the two
published presets, the mode-0 fields of EvalConfig and the single-device
fields of TrainConfig). Mesh fields are absent: this package runs one card."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters of MP_HSIR_Net (reference
    net/MP_HSIR.py:763-808)."""

    in_channels: int = 31
    out_channels: int = 31
    dim: int = 64
    num_blocks: Tuple[int, int, int] = (2, 4, 6)
    num_refinement_blocks: int = 4
    heads: Tuple[int, int, int] = (2, 4, 8)
    window_size: Tuple[int, int, int] = (8, 8, 8)
    task_classes: int = 6
    ffn_expansion_factor: float = 2.66
    bias: bool = False
    compress_ratios: Tuple[int, int, int] = (8, 16, 32)
    prompt_len: int = 128
    prompt_sizes: Tuple[int, int] = (64, 32)
    drop_path_max: float = 0.1
    # resolution the shifted-window decision is frozen at (reference
    # MP_HSIR.py:791 input_resolution=[64, 64])
    train_resolution: Tuple[int, int] = (64, 64)
    # "float32" or "bfloat16": the dtype the forward computes in; LayerNorm,
    # softmax and every accumulation stay float32 inside it
    compute_dtype: str = "float32"

    @property
    def dims(self) -> Tuple[int, int, int]:
        return (self.dim, self.dim * 2, self.dim * 4)


def natural_scene_config(**kw) -> ModelConfig:
    """31-band natural-scene preset (reference test.py:39)."""
    return ModelConfig(in_channels=31, out_channels=31, dim=64, task_classes=6, **kw)


def remote_sensing_config(**kw) -> ModelConfig:
    """100-band remote-sensing preset (reference train.py:45)."""
    return ModelConfig(in_channels=100, out_channels=100, dim=96, task_classes=7, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Single-device training knobs (the fields of JAX ``TrainConfig``,
    reference train.py:68-120, that the train step and its callers read)."""

    seed: int = 2024
    epochs: int = 100
    steps_per_epoch: int = 1000
    batch_size: int = 32
    lr: float = 2e-4
    eta_min: float = 1e-6
    warmup_frac: float = 0.1
    weight_decay: float = 0.01  # torch AdamW default
    patch_size: int = 64
    data_type: str = "remote_sensing"  # or "natural_scene"
    de_types: Tuple[str, ...] = ()
    grad_accum: int = 1

    def de_types_resolved(self) -> Tuple[str, ...]:
        """The degradations a training batch draws from: ``de_types``, else
        the preset's own list (the remote-sensing one adds haze)."""
        if self.de_types:
            return self.de_types
        if self.data_type == "natural_scene":
            return ("gaussianN", "complexN", "blur", "sr", "inpaint", "bandmiss")
        return ("gaussianN", "complexN", "blur", "sr", "inpaint", "haze", "bandmiss")


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Mode-0 evaluation knobs (reference test.py:541-569)."""

    seed: int = 2024
    mode: int = 0
    test_dir: str = ""
    gaussian_noise_sigma: int = 70
    select_bands: Tuple[int, ...] = (27, 15, 9)
    output_path: str = "output/"
    ckpt_path: str = ""
    save_images: bool = True
