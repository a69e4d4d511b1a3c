"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points default to the card, its host-side copies equal
the JAX package's originals, and its mode-0 CLI keeps the stdout contract."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import torch_threads  # noqa: E402  (one compute thread per process)

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "mp_hsir_tpu_torch"


def _modules():
    return sorted(".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
                  for p in PKG.rglob("*.py"))


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'triton', 'mp_hsir_tpu')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=torch_threads.SUBPROCESS_ENV,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in PKG.rglob("*.py"))
                         + ["chip_smoke.py"])
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse((REPO / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    for n in names:
        root = n.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "triton", "mp_hsir_tpu"), (path, n)


def test_default_device_is_cuda():
    from mp_hsir_tpu_torch import resolve_device
    from mp_hsir_tpu_torch.config import ModelConfig
    from mp_hsir_tpu_torch.models.mp_hsir import build_model

    cfg = ModelConfig(in_channels=5, out_channels=5, dim=16, num_blocks=(1, 1, 1),
                      num_refinement_blocks=1, heads=(2, 2, 2))
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    assert next(build_model(cfg, device="cpu").parameters()).device.type == "cpu"


@pytest.mark.parametrize("task_classes", [1, 6, 7])
def test_clip_table_equals_jax(task_classes):
    from mp_hsir_tpu.models.text_prompts import clip_text_table as jax_table
    from mp_hsir_tpu_torch.models.text_prompts import clip_text_table

    np.testing.assert_array_equal(clip_text_table(task_classes), jax_table(task_classes))


def test_prompt_weights_and_embedding_equal_jax():
    from mp_hsir_tpu.models import text_prompts as J
    from mp_hsir_tpu_torch.models import text_prompts as T

    ids = np.array([[0, 3], [5, 5]])
    want_w = np.asarray(J.text_prompt_weights(jnp.asarray(ids), 6))
    got_w = T.text_prompt_weights(torch.as_tensor(ids), 6)
    np.testing.assert_array_equal(got_w.numpy(), want_w)
    np.testing.assert_allclose(T.clip_prompt_embedding(got_w, 6).numpy(),
                               np.asarray(J.clip_prompt_embedding(jnp.asarray(want_w), 6)),
                               atol=1e-6)


def test_metrics_equal_jax():
    from mp_hsir_tpu.ops import metrics as JM
    from mp_hsir_tpu_torch.ops import metrics as TM

    rng = np.random.default_rng(8)
    clean = rng.random((1, 6, 32, 32)).astype(np.float32)
    noisy = (clean + rng.standard_normal(clean.shape) * 0.1).astype(np.float32)
    p, s, n = TM.compute_psnr_ssim(torch.from_numpy(noisy), torch.from_numpy(clean))
    jp, js, jn = JM.compute_psnr_ssim(jnp.asarray(noisy), jnp.asarray(clean))
    assert n == jn
    assert abs(p - jp) < 1e-4 and abs(s - js) < 1e-5
    sam = TM.compute_sam(torch.from_numpy(noisy), torch.from_numpy(clean))
    assert abs(sam - JM.compute_sam(jnp.asarray(noisy), jnp.asarray(clean))) < 1e-3


def test_eval_data_equals_jax(tmp_path):
    """The copied .mat loading and mode-0 degradation give the JAX
    dataset's items bit for bit."""
    from mp_hsir_tpu.config import EvalConfig
    from mp_hsir_tpu.data.eval_datasets import GaussianDenoiseDataset as JaxDataset
    from mp_hsir_tpu.utils.image import save_mat_cube
    from mp_hsir_tpu_torch.config import EvalConfig as PortEvalConfig
    from mp_hsir_tpu_torch.data.eval_datasets import GaussianDenoiseDataset

    rng = np.random.default_rng(9)
    for i in range(2):
        save_mat_cube(str(tmp_path / f"c{i}.mat"), rng.random((70, 66, 31)).astype(np.float32))
    want = list(JaxDataset(EvalConfig(test_dir=str(tmp_path))))
    got = list(GaussianDenoiseDataset(PortEvalConfig(test_dir=str(tmp_path))))
    assert [g["name"] for g in got] == [w["name"] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["clean"], w["clean"])
        np.testing.assert_array_equal(g["degraded"], w["degraded"])


def test_cli_mode0_stdout_contract(tmp_path):
    """The port CLI on the CPU prints the JAX CLI's banner and two result
    lines (random weights, tiny cube: the format is what is checked)."""
    import scipy.io as sio

    d = tmp_path / "cubes"
    d.mkdir()
    sio.savemat(str(d / "a.mat"), {"data": np.random.default_rng(1).random((64, 64, 31)).astype(np.float32)})
    r = subprocess.run(
        [sys.executable, "-m", "mp_hsir_tpu_torch.cli.test_cli", "--mode", "0", "--test_dir",
         str(d), "--device", "cpu", "--no_save_images"],
        cwd=REPO, env=torch_threads.SUBPROCESS_ENV, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[0] == "Start gaussian denoise testing sigma=70"
    assert lines[1] == "Total Test HSIs Ids : 1"
    assert lines[2].startswith("Denoise sigma=70: psnr: ") and ", ssim: " in lines[2]
    assert lines[3].startswith("Denoise sigma=70: sam: ") and lines[3].endswith(" s/cube")


def test_build_flags_target_sm90a():
    from mp_hsir_tpu_torch.ops.kernels import _build

    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    srcs, hdrs = _build._sources()
    assert {os.path.basename(s) for s in srcs} == {
        "window_attention.cu", "spectral.cu", "conv3.cu", "gdfn.cu", "mlp.cu", "grad.cu"}
    assert _build._digest(srcs + hdrs) == _build._digest(srcs + hdrs)
