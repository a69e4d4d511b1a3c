"""Typed configuration (mirrors ``mp_hsir_tpu/config.py``: ModelConfig, the two
published presets, and every field of EvalConfig and TrainConfig with JAX's
defaults). JAX's ``ModelConfig.spatial_axis`` has no field here: the port's
model takes the spatial mesh axis, a process group's handle, as the
``axis`` argument of its forward (``parallel/mesh.py``); the eval CLI's
``--mesh_spatial`` passes it. The train CLI raises on any mesh size other
than 1 (the sharded train step is later work)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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
    """Training knobs (JAX ``TrainConfig``, reference train.py:68-120)."""

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
    db_path: str = ""
    ckpt_dir: str = "ckpt"
    ckpt_every_epochs: int = 50
    resume_from: Optional[str] = None
    grad_accum: int = 1
    # mesh sizes along (data, spatial); only 1 x 1 runs in this package
    mesh_data: int = 1
    mesh_spatial: int = 1
    mixed_precision: bool = True  # bf16 compute (reference uses fp16-mixed)
    log_every: int = 50
    # input pipeline (data/train_pipeline.py): the dtype clean patches cross
    # the host -> device link in ("float32", "float16", "bfloat16", or
    # "uint16" fixed point); resident_bank uploads the patch store once and
    # gathers each batch on the device, bank_patches caps the bank and
    # refresh_per_step streams that many fresh patches into it per step
    upload_dtype: str = "float32"
    resident_bank: bool = False
    bank_patches: Optional[int] = None
    refresh_per_step: int = 0
    prefetch: int = 2

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
    """Evaluation knobs (JAX ``EvalConfig``, reference test.py:541-569)."""

    seed: int = 2024
    mode: int = 0
    test_dir: str = ""
    # mode 12: the directory of real degraded cubes paired by name order
    test_degrad_dir: str = ""
    gaussian_noise_sigma: int = 70
    gaussian_noise_sigmas: Tuple[int, ...] = (10, 30, 50, 70)
    stripe_noise_ratio: Tuple[float, float] = (0.05, 0.15)
    deadline_noise_ratio: Tuple[float, float] = (0.05, 0.15)
    impulse_noise_ratio: Tuple[float, ...] = (0.1, 0.3, 0.5, 0.7)
    gaussian_blur_radius: int = 15
    motion_blur: Tuple[int, int] = (15, 45)
    downsample_factor: int = 8
    mask_ratio: float = 0.9
    haze_omega: float = 1.0
    bandmis_ratio: float = 0.3
    poisson_scale: float = 10.0
    # label-only id printed by modes 11/12 (reference --degrad_id, default 1,
    # test.py:552); the prompt those modes route stays 0 / 1
    degrad_id: int = 1
    select_bands: Tuple[int, ...] = (27, 15, 9)
    output_path: str = "output/"
    ckpt_path: str = ""
    save_images: bool = True
    # streaming eval: up to `pipeline` cubes in flight (a producer thread for
    # the dataset, an uploader thread for the host -> device copies, one
    # (4,) metric vector read back per cube); 1 = the synchronous loop
    pipeline: int = 1
    # the dtype the pipelined loop's cubes cross the host -> device link in
    # ("float32", "float16", "bfloat16"); they are widened to float32 on the
    # device before the forward and the metrics
    upload_dtype: str = "float32"
