"""The PyTorch port's model against the JAX package's jnp path, on the CPU in
float32, on the same weights and inputs.

* the tiny configuration (dim 16, 32x32): the whole eval forward, random
  weights, batch 1 (tasks 0 and 3) and batch 2 with mixed tasks [0, 3];
  tolerance 1e-4 absolute (float32, different summation orders);
* the training fields of ``TrainConfig`` and ``de_types_resolved()`` for
  both data types;
* the flagship preset on the committed trained weights at 64x64 on the
  mode-0 cube of tests/test_quality_artifact.py: max-abs error bound and a
  PSNR difference of at most 0.01 dB.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

import dataclasses

from mp_hsir_tpu.config import ModelConfig as JaxModelConfig
from mp_hsir_tpu.config import TrainConfig as JaxTrainConfig
from mp_hsir_tpu.config import natural_scene_config as jax_natural_scene_config
from mp_hsir_tpu.models.mp_hsir import MPHSIRNet as JaxNet
from mp_hsir_tpu.models.mp_hsir import init_params
from mp_hsir_tpu_torch.checkpoint import load_params_npz, params_from_jax
from mp_hsir_tpu_torch.config import ModelConfig, TrainConfig, natural_scene_config
from mp_hsir_tpu_torch.data.degradations_np import gaussian_noise_fixed
from mp_hsir_tpu_torch.models import layers as L
from mp_hsir_tpu_torch.models.mp_hsir import build_model
from mp_hsir_tpu_torch.ops.kernels import _route
import torch_threads  # noqa: E402,F401  (one compute thread per process)

ART = os.path.join(os.path.dirname(__file__), "..", "assets", "trained", "natural_12k_f16.npz")
TINY = dict(in_channels=5, out_channels=5, dim=16, num_blocks=(1, 1, 1),
            num_refinement_blocks=1, heads=(2, 2, 2), task_classes=6)


def _band_psnr(a, b):
    mse = np.mean((a - b) ** 2, axis=(-2, -1))
    return float(np.mean(10.0 * np.log10(1.0 / np.maximum(mse, 1e-12))))


def _quality_cube():
    """The held-out smooth cube and its sigma=70 degradation, built exactly
    as tests/test_quality_artifact.py builds them."""
    rng = np.random.default_rng(990)
    base = rng.standard_normal((4, 8, 8)).astype(np.float32)
    maps = np.stack([np.kron(b, np.ones((8, 8), np.float32)) for b in base])
    t = np.linspace(0, 1, 31, dtype=np.float32)
    mix = np.stack([np.sin(2 * np.pi * (f * t + p))
                    for f, p in ((1.0, 0.0), (1.5, 0.3), (0.7, 0.6), (2.0, 0.9))])
    clean = np.einsum("kc,khw->chw", mix, maps)
    clean -= clean.min()
    clean /= clean.max() + 1e-9
    degraded = np.clip(gaussian_noise_fixed(clean, np.random.default_rng(2024), 70), 0.0, 1.0)
    return clean, degraded


@pytest.mark.parametrize("tasks", [pytest.param((0,), id="0"), pytest.param((3,), id="3"),
                                   pytest.param((0, 3), id="batch2-0-3")])
def test_tiny_model_matches_jax(tasks):
    jc = JaxModelConfig(**TINY)
    params = init_params(jc, jax.random.key(0), sample_hw=32)
    x = np.random.default_rng(tasks[0]).random((len(tasks), 5, 32, 32)).astype(np.float32)
    jm = JaxNet(jc)
    want = np.asarray(jax.jit(lambda p, x, t: jm.apply({"params": p}, x, t))(
        params, jnp.asarray(x), jnp.asarray(tasks, jnp.int32)))

    model = build_model(ModelConfig(**TINY), device="cpu")
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    model.load_state_dict(params_from_jax(flat, model.state_dict()))
    L.reset_path_stats()
    _route.reset_counters()
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.tensor(tasks)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    # every PGSSTB and PromptFusion took the kernel route; on the CPU the
    # wrappers ran their plain versions and launched nothing
    assert L.PATH_STATS == {"pgsstb_kernels": 6, "prompt_fusion_kernels": 2}
    assert all(c.launches == 0 for c in _route.COUNTERS.values())


@pytest.mark.skipif(not os.path.exists(ART), reason="trained artifact not committed")
def test_flagship_trained_weights_match_jax():
    from mp_hsir_tpu.training import checkpoint as CKPT

    clean, degraded = _quality_cube()
    # the jitted forward of tests/test_quality_artifact.py, so both tests
    # share one persistent compile-cache entry
    cfg = jax_natural_scene_config(use_pallas_attention=False)
    params = init_params(cfg, jax.random.key(0), sample_hw=64)
    params = CKPT.restore_params(ART, params)
    model = JaxNet(cfg)
    want = np.asarray(jax.jit(lambda p, x, t: model.apply({"params": p}, x, t))(
        params, jnp.asarray(degraded)[None], jnp.zeros((1,), jnp.int32)))[0]

    port = build_model(natural_scene_config(), device="cpu")
    load_params_npz(ART, port)
    with torch.no_grad():
        got = port(torch.from_numpy(degraded)[None], torch.zeros(1, dtype=torch.long)).numpy()[0]
    # float32 on both sides through 22 blocks: 1e-3 absolute on outputs of
    # order 1 (measured ~1e-5; the bound leaves room for summation order)
    assert np.abs(got - want).max() < 1e-3
    p_jax = _band_psnr(np.clip(want, 0, 1), clean)
    p_port = _band_psnr(np.clip(got, 0, 1), clean)
    assert abs(p_port - p_jax) <= 0.01, (p_port, p_jax)
    assert p_port - _band_psnr(degraded, clean) >= 3.0


@pytest.mark.parametrize("data_type", ["remote_sensing", "natural_scene"])
def test_train_config_fields_match_jax(data_type):
    """Every port TrainConfig field has JAX's name and default, and the
    degradation list resolves as JAX's does (default and explicit)."""
    port, jax_tc = TrainConfig(data_type=data_type), JaxTrainConfig(data_type=data_type)
    for f in dataclasses.fields(TrainConfig):
        assert getattr(port, f.name) == getattr(jax_tc, f.name), f.name
    assert {"batch_size", "patch_size", "data_type", "de_types"} <= {
        f.name for f in dataclasses.fields(TrainConfig)}
    assert TrainConfig().data_type == JaxTrainConfig().data_type == "remote_sensing"
    assert port.de_types_resolved() == jax_tc.de_types_resolved()
    picked = ("blur", "haze")
    assert (TrainConfig(data_type=data_type, de_types=picked).de_types_resolved()
            == JaxTrainConfig(data_type=data_type, de_types=picked).de_types_resolved() == picked)
