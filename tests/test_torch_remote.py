"""The 100-band remote-sensing preset in the PyTorch port, on the CPU:

* every parameter of JAX ``remote_sensing_config()`` maps through
  ``params_from_jax`` to a port tensor of the same shape (JAX shapes from
  ``jax.eval_shape``, no forward computed);
* a tiny 100-band, 7-task model (dim 16, one block per level) against the
  JAX jnp path at 32x32, float32, same weights, tasks 0 and 6: 1e-4
  absolute (float32, other summation orders), as the natural-scene tiny test;
* the port CLI with ``--data_type remote_sensing`` prints the JAX CLI's four
  mode-0 lines.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from mp_hsir_tpu.config import ModelConfig as JaxModelConfig
from mp_hsir_tpu.config import remote_sensing_config as jax_remote_sensing_config
from mp_hsir_tpu.models.mp_hsir import MPHSIRNet as JaxNet
from mp_hsir_tpu.models.mp_hsir import init_params
from mp_hsir_tpu_torch.checkpoint import params_from_jax
from mp_hsir_tpu_torch.config import ModelConfig, remote_sensing_config
from mp_hsir_tpu_torch.models import layers as L
from mp_hsir_tpu_torch.models.mp_hsir import build_model
import torch_threads  # noqa: E402  (one compute thread per process)

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY_RS = dict(in_channels=100, out_channels=100, dim=16, num_blocks=(1, 1, 1),
               num_refinement_blocks=1, heads=(2, 2, 2), task_classes=7)


def test_remote_sensing_params_map_to_port_tensors():
    cfg = jax_remote_sensing_config()
    shapes = jax.eval_shape(lambda r: init_params(cfg, r, sample_hw=64), jax.random.key(0))
    flat = {k: np.zeros(v.shape, np.float32)
            for k, v in traverse_util.flatten_dict(shapes, sep="/").items()}
    port = build_model(remote_sensing_config(), device="cpu")
    # raises on a missing or extra key and on any shape mismatch
    sd = params_from_jax(flat, port.state_dict())
    assert len(sd) == len(port.state_dict()) == len(flat)
    assert port.patch_embed.proj.weight.shape == (96, 100, 3, 3)
    assert port.latent.blocks_0.attn.qkv.weight.shape == (3 * 384, 384)
    assert port.prompt1.text_prompt_learnable.shape == (7, 96)


@pytest.mark.parametrize("task", [0, 6])
def test_tiny_remote_sensing_model_matches_jax(task):
    jc = JaxModelConfig(**TINY_RS)
    params = init_params(jc, jax.random.key(1), sample_hw=32)
    x = np.random.default_rng(10 + task).random((1, 100, 32, 32)).astype(np.float32)
    jm = JaxNet(jc)
    want = np.asarray(jax.jit(lambda p, x, t: jm.apply({"params": p}, x, t))(
        params, jnp.asarray(x), jnp.asarray([task], jnp.int32)))

    model = build_model(ModelConfig(**TINY_RS), device="cpu")
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    model.load_state_dict(params_from_jax(flat, model.state_dict()))
    L.reset_path_stats()
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.tensor([task])).numpy()
    assert got.shape == (1, 100, 32, 32)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert L.PATH_STATS == {"pgsstb_kernels": 6, "prompt_fusion_kernels": 2}


def test_cli_remote_sensing_stdout_contract(tmp_path):
    """The full preset (random weights) on one 100x64x64 cube on the CPU: the
    JAX CLI's banner, dataset line and two result lines. The cube is stored
    band-first: the loader takes the last axis for bands only where it is the
    smallest, and eval cubes are cropped to multiples of 64."""
    import scipy.io as sio

    d = tmp_path / "cubes"
    d.mkdir()
    cube = np.random.default_rng(2).random((100, 64, 64)).astype(np.float32)
    sio.savemat(str(d / "rs.mat"), {"data": cube})
    r = subprocess.run(
        [sys.executable, "-m", "mp_hsir_tpu_torch.cli.test_cli", "--mode", "0", "--test_dir",
         str(d), "--data_type", "remote_sensing", "--device", "cpu", "--no_save_images"],
        cwd=REPO, env=torch_threads.SUBPROCESS_ENV, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 4, lines
    assert lines[0] == "Start gaussian denoise testing sigma=70"
    assert lines[1] == "Total Test HSIs Ids : 1"
    assert lines[2].startswith("Denoise sigma=70: psnr: ") and ", ssim: " in lines[2]
    assert lines[3].startswith("Denoise sigma=70: sam: ") and lines[3].endswith(" s/cube")
