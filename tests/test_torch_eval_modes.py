"""The port's eval entry point against the JAX package's, on the CPU:

* every mode's dataset items against JAX ``MODE_DATASETS[mode](cfg)`` on
  seeded .mat cubes, bit for bit except modes 7 and 9 (see
  ``test_dataset_items_equal_jax``);
* the band-missing metric and the fused (4,) metric vector against JAX's
  ``compute_psnr_ssim_missing_bands`` and ``_make_eval_step``'s arithmetic:
  PSNR 1e-4, SSIM 1e-5 (float32 sums in other orders);
* the committed goldens of all 13 modes (``tests/goldens/eval_goldens.json``)
  met by the port's ``run_mode`` on the tiny seed-0 JAX model carried over
  with ``params_from_jax``, at ``scripts/golden_sweep.py``'s tolerances;
* mode 10 of a tiny 100-band, 7-task model: task 6 routed, and JAX's
  ``run_mode`` matched on the same weights;
* the pipelined loop against the synchronous one (float32 upload 1e-4 /
  1e-5 / 1e-4 for PSNR / SSIM / SAM, float16 0.05 / 1e-3 / 0.05, as
  ``tests/test_eval_cli.py`` holds JAX's), the router consulted once per cube
  in both loops, and a failing stage raised in the caller;
* ``FFCResNet`` logits against flax on the same variables (1e-4 of their
  max abs), the variable bridge against flax's own tree, the label map and
  the routed id;
* the CLI's stdout lines for every mode through ``main`` in process, and
  once in a subprocess with ``--pipeline 2 --upload_dtype float16``.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import scipy.io as sio
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from mp_hsir_tpu.cli import test_cli as JCLI
from mp_hsir_tpu.config import EvalConfig as JaxEvalConfig
from mp_hsir_tpu.config import ModelConfig as JaxModelConfig
from mp_hsir_tpu.data import eval_datasets as JED
from mp_hsir_tpu.models import classifier as JC
from mp_hsir_tpu.models.mp_hsir import MPHSIRNet as JaxNet
from mp_hsir_tpu.models.mp_hsir import init_params
from mp_hsir_tpu.ops import metrics as JM
from mp_hsir_tpu_torch.checkpoint import (
    classifier_params_from_jax, classifier_params_to_jax, load_classifier_npz, params_from_jax,
    params_to_jax, save_classifier_npz,
)
from mp_hsir_tpu_torch.cli import test_cli as CLI
from mp_hsir_tpu_torch.config import EvalConfig, ModelConfig
from mp_hsir_tpu_torch.data import eval_datasets as ED
from mp_hsir_tpu_torch.models import classifier as TC
from mp_hsir_tpu_torch.models.mp_hsir import build_model
from mp_hsir_tpu_torch.ops import metrics as TM

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
import golden_sweep as GS  # noqa: E402
import torch_threads  # noqa: E402  (one compute thread per process)

TINY = dict(in_channels=31, out_channels=31, dim=16, num_blocks=(1, 1, 1),
            num_refinement_blocks=1, heads=(2, 2, 2), task_classes=6)
TINY_RS = dict(TINY, in_channels=100, out_channels=100, task_classes=7)
MODES = list(range(13))


def _smooth_cube(rng, bands=31):
    base = rng.uniform(0.2, 0.8, (bands, 8, 8)).astype(np.float32)
    return np.stack([np.kron(b, np.ones((8, 8), np.float32)) for b in base])


@pytest.fixture(scope="module")
def golden_dirs(tmp_path_factory):
    """scripts/golden_sweep.py's fixture: one clean 31x64x64 cube and its
    paired 'real degraded' copy."""
    root = tmp_path_factory.mktemp("golden")
    clean, degraded = root / "cubes", root / "cubes_degraded"
    clean.mkdir()
    degraded.mkdir()
    GS.make_fixture(str(clean))
    GS.make_degraded_fixture(str(clean), str(degraded))
    return str(clean), str(degraded)


@pytest.fixture(scope="module")
def tiny_model():
    """The golden sweep's tiny model (JAX init, key 0, sample 64x64) carried
    over to the port."""
    params = init_params(JaxModelConfig(**TINY), jax.random.key(0), sample_hw=64)
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    model = build_model(ModelConfig(**TINY), device="cpu")
    model.load_state_dict(params_from_jax(flat, model.state_dict()))
    return model


@pytest.fixture(scope="module")
def two_cubes(tmp_path_factory):
    """Two smooth 31x64x64 cubes, so that the pipelined loop has two in flight."""
    d = tmp_path_factory.mktemp("two")
    rng = np.random.default_rng(7)
    for k in range(2):
        sio.savemat(str(d / f"cube_{k}.mat"), {"data": _smooth_cube(rng).transpose(1, 2, 0)})
    return str(d)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset_dirs(tmp_path_factory):
    """Two seeded 31-band cubes stored HWC (70x66: cropped to 64x64) and a
    paired degraded directory for mode 12."""
    root = tmp_path_factory.mktemp("data")
    clean, degraded = root / "clean", root / "degraded"
    clean.mkdir()
    degraded.mkdir()
    rng = np.random.default_rng(9)
    for i in range(2):
        cube = rng.random((70, 66, 31)).astype(np.float32)
        sio.savemat(str(clean / f"c{i}.mat"), {"data": cube})
        noisy = np.clip(cube + rng.normal(0, 0.1, cube.shape), 0, 1).astype(np.float32)
        sio.savemat(str(degraded / f"c{i}.mat"), {"data": noisy})
    return str(clean), str(degraded)


@pytest.mark.parametrize("mode", MODES + ["impulse_inid"])
def test_dataset_items_equal_jax(mode, dataset_dirs):
    """Bit for bit, except where the two packages compute a step with other
    code: mode 7's bicubic downsample (JAX's jnp matrix product against
    this package's torch one: float32 sums that may run in other orders)
    and mode 9's cirrus template (OpenCV's INTER_LINEAR in JAX against this
    package's numpy copy of it, which agrees within one float32 ulp) are
    held to 1e-6 absolute on [0, 1] data. On these cubes both came out bit
    for bit equal too."""
    clean_dir, degrad_dir = dataset_dirs
    kw = dict(test_dir=clean_dir, test_degrad_dir=degrad_dir)
    if mode == "impulse_inid":
        want = list(JED.ImpulseDenoiseInidDataset(JaxEvalConfig(**kw)))
        got = list(ED.ImpulseDenoiseInidDataset(EvalConfig(**kw)))
    else:
        want = list(JED.MODE_DATASETS[mode](JaxEvalConfig(**kw)))
        got = list(ED.MODE_DATASETS[mode](EvalConfig(**kw)))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) and g["name"] == w["name"]
        for key in ("clean", "degraded", "mask"):
            if key not in w:
                continue
            assert g[key].dtype == w[key].dtype == np.float32 and g[key].shape == w[key].shape
            if mode in (7, 9) and key == "degraded":
                np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(g[key], w[key])


def test_mode12_without_degrad_dir_exits_clearly(dataset_dirs):
    with pytest.raises(SystemExit, match="--test_degrad_dir"):
        ED.RealDegradDataset(EvalConfig(test_dir=dataset_dirs[0]))


def test_dehaze_reads_haze_templates(dataset_dirs, tmp_path):
    """A haze_dir template (key "haze") replaces the default cirrus, as in JAX;
    a file without the key is skipped."""
    rng = np.random.default_rng(3)
    sio.savemat(str(tmp_path / "h0.mat"), {"haze": rng.random((40, 40)).astype(np.float32)})
    sio.savemat(str(tmp_path / "x.mat"), {"data": rng.random((4, 4)).astype(np.float32)})
    kw = dict(test_dir=dataset_dirs[0])
    want = list(JED.DehazeDataset(JaxEvalConfig(**kw), haze_dir=str(tmp_path)))
    got = list(ED.DehazeDataset(EvalConfig(**kw), haze_dir=str(tmp_path)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["degraded"], w["degraded"], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _metric_inputs(missing):
    rng = np.random.default_rng(5)
    clean = rng.random((2, 6, 32, 32)).astype(np.float32)
    restored = (clean + rng.standard_normal(clean.shape) * 0.05).astype(np.float32)
    degraded = clean.copy()
    if missing:  # cube 0 loses bands 1 and 4, cube 1 none
        degraded[0, [1, 4]] = 0.0
    return restored, clean, degraded


@pytest.mark.parametrize("missing", [True, False])
def test_missing_band_metric_equals_jax(missing):
    restored, clean, degraded = _metric_inputs(missing)
    got = TM.compute_psnr_ssim_missing_bands(*map(torch.from_numpy, (restored, clean, degraded)))
    want = JM.compute_psnr_ssim_missing_bands(*map(jnp.asarray, (restored, clean, degraded)))
    assert got[2] == want[2] == (1 if missing else 0)
    assert abs(got[0] - want[0]) < 1e-4 and abs(got[1] - want[1]) < 1e-5


@pytest.mark.parametrize("mode,missing", [(0, False), (10, True), (10, False)])
def test_eval_metrics_vector_equals_jax_eval_step(mode, missing):
    """The (4,) [psnr, ssim, count, sam] of one step, against the JAX CLI's
    fused step with a forward that returns the same restored cube."""
    restored, clean, degraded = _metric_inputs(missing)
    jstep = JCLI._make_eval_step(lambda p, x, t: jnp.asarray(restored), mode, False)
    want = np.asarray(jstep(None, jnp.asarray(degraded), jnp.asarray(clean), jnp.asarray([0]))[0])
    got = TM.eval_metrics(*map(torch.from_numpy, (restored, clean, degraded)), mode == 10).numpy()
    assert got.dtype == np.float32 and got.shape == (4,)
    assert got[2] == want[2]
    np.testing.assert_allclose(got[[0, 3]], want[[0, 3]], rtol=0, atol=1e-4)
    assert abs(got[1] - want[1]) < 1e-5


# ---------------------------------------------------------------------------
# the goldens and the loops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_run_mode_meets_goldens(mode, tiny_model, golden_dirs, tmp_path):
    clean_dir, degrad_dir = golden_dirs
    cfg = EvalConfig(mode=mode, test_dir=clean_dir, test_degrad_dir=degrad_dir,
                     output_path=str(tmp_path), save_images=False)
    r = CLI.run_mode(cfg, ModelConfig(**TINY), model=tiny_model, device="cpu")
    got = {str(mode): {k: float(r[k]) for k in ("psnr", "ssim", "sam")}}
    with open(GS.GOLDEN_PATH) as fh:
        goldens = json.load(fh)
    assert GS.compare(got, goldens) == []


def test_remote_sensing_bandmis_routes_task6_and_matches_jax(tmp_path):
    """Mode 10 on a tiny 100-band 7-task model: the port routes prompt 6 and
    scores as JAX's run_mode does with the same weights (1e-4 / 1e-5 / 1e-4)."""
    d = tmp_path / "cubes"
    d.mkdir()
    cube = _smooth_cube(np.random.default_rng(21), bands=100)  # band-first (100, 64, 64)
    sio.savemat(str(d / "rs.mat"), {"data": cube})
    torch.manual_seed(0)
    model = build_model(ModelConfig(**TINY_RS), device="cpu")
    flat = params_to_jax(model.state_dict())
    params = traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})
    jm = JaxNet(JaxModelConfig(**TINY_RS))
    fwd = jax.jit(lambda p, x, t: jm.apply({"params": p}, x, t))
    seen = []

    def spy(x, t):
        seen.append(int(t[0]))
        return model(x, t)

    kw = dict(mode=10, test_dir=str(d), save_images=False, output_path=str(tmp_path))
    got = CLI.run_mode(EvalConfig(**kw), ModelConfig(**TINY_RS), model=spy, device="cpu")
    want = JCLI.run_mode(JaxEvalConfig(**kw), JaxModelConfig(**TINY_RS), params=params, fwd=fwd)
    assert seen == [6, 6]  # the warm-up and the timed call
    np.testing.assert_allclose(got["psnr"], want["psnr"], atol=1e-4)
    np.testing.assert_allclose(got["ssim"], want["ssim"], atol=1e-5)
    np.testing.assert_allclose(got["sam"], want["sam"], atol=1e-4)


@pytest.mark.parametrize("mode", [0, 7, 10])
def test_pipelined_matches_sync(mode, tiny_model, two_cubes, tmp_path):
    cfg = EvalConfig(mode=mode, test_dir=two_cubes, output_path=str(tmp_path), save_images=False)
    cfg_m = ModelConfig(**TINY)
    sync = CLI.run_mode(cfg, cfg_m, model=tiny_model, device="cpu")
    for dtype, tol in (("float32", (1e-4, 1e-5, 1e-4)), ("float16", (0.05, 1e-3, 0.05))):
        piped = CLI.run_mode(dataclasses.replace(cfg, pipeline=2, upload_dtype=dtype), cfg_m,
                             model=tiny_model, device="cpu")
        for key, atol in zip(("psnr", "ssim", "sam"), tol):
            np.testing.assert_allclose(piped[key], sync[key], atol=atol, err_msg=f"{dtype} {key}")


def test_router_consulted_once_per_cube_in_both_loops(tiny_model, two_cubes, tmp_path):
    calls = []

    def router(degraded):
        calls.append(degraded.shape)
        return 2

    seen = []

    def spy(x, t):
        seen.append(int(t[0]))
        return tiny_model(x, t)

    cfg = EvalConfig(mode=0, test_dir=two_cubes, output_path=str(tmp_path), save_images=False)
    sync = CLI.run_mode(cfg, ModelConfig(**TINY), model=spy, device="cpu", task_router=router)
    assert calls == [(1, 31, 64, 64)] * 2
    piped = CLI.run_mode(dataclasses.replace(cfg, pipeline=2), ModelConfig(**TINY), model=spy,
                         device="cpu", task_router=router)
    assert len(calls) == 4 and set(seen) == {2}
    np.testing.assert_allclose(piped["psnr"], sync["psnr"], atol=1e-4)
    np.testing.assert_allclose(piped["ssim"], sync["ssim"], atol=1e-5)


def test_pipeline_stage_errors_reach_the_caller(tiny_model, two_cubes, tmp_path, monkeypatch):
    class Broken(ED.GaussianDenoiseDataset):
        def __iter__(self):
            yield from ()
            raise ValueError("producer failed")

    cfg = EvalConfig(mode=0, test_dir=two_cubes, output_path=str(tmp_path), save_images=False,
                     pipeline=2)
    monkeypatch.setitem(CLI.MODE_DATASETS, 0, Broken)
    with pytest.raises(RuntimeError, match="stage failed") as info:
        CLI.run_mode(cfg, ModelConfig(**TINY), model=tiny_model, device="cpu")
    assert isinstance(info.value.__cause__, ValueError)
    monkeypatch.undo()

    def bad_router(degraded):
        raise KeyError("router failed")

    with pytest.raises(RuntimeError, match="stage failed") as info:
        CLI.run_mode(cfg, ModelConfig(**TINY), model=tiny_model, device="cpu",
                     task_router=bad_router)
    assert isinstance(info.value.__cause__, KeyError)


def test_pipelined_saves_images(tiny_model, two_cubes, tmp_path):
    cfg = EvalConfig(mode=8, test_dir=two_cubes, output_path=str(tmp_path), pipeline=2,
                     upload_dtype="bfloat16")
    r = CLI.run_mode(cfg, ModelConfig(**TINY), model=tiny_model, device="cpu")
    assert np.isfinite([r["psnr"], r["ssim"], r["sam"]]).all()
    names = sorted(os.listdir(tmp_path / "inpaint"))
    assert names == sorted(f"{k}_cube_{i}.png" for k in ("origin", "degraded", "restored")
                           for i in range(2))


def test_model_trains_after_an_inference_mode_forward():
    """The device constants a forward caches on first use (the CLIP table,
    the nearest-resize indices, the shift-region labels) are made inside the
    eval CLI's inference mode and must still serve a later train step."""
    from mp_hsir_tpu_torch.models import text_prompts
    from mp_hsir_tpu_torch.ops import resize
    from mp_hsir_tpu_torch.ops.kernels import window_attention

    for cached in (text_prompts._device_table, resize._nearest_index,
                   window_attention.region_labels):
        cached.cache_clear()
    torch.manual_seed(1)
    model = build_model(ModelConfig(**dict(TINY, in_channels=5, out_channels=5)), device="cpu")
    x, tid = torch.rand(1, 5, 32, 32), torch.tensor([2])
    with torch.inference_mode():
        model(x, tid)
    model.train()
    model(x, tid, torch.Generator().manual_seed(0)).square().mean().backward()
    assert model.patch_embed.proj.weight.grad is not None


# ---------------------------------------------------------------------------
# the classifier
# ---------------------------------------------------------------------------

CLASSIFIER_KW = dict(in_channel=5, layers=(1, 1, 1, 1), inplanes=16, num_classes=5,
                     size=(64, 64), enable_lfu=True)


def _seeded_classifier(**kw):
    torch.manual_seed(3)
    model = TC.FFCResNet(**kw)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():  # running statistics away from the identity, so they count
        for m in model.modules():
            if isinstance(m, TC._BN):
                m.running_mean.uniform_(-0.2, 0.2, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.8, 1.2, generator=g)
                m.bias.uniform_(-0.1, 0.1, generator=g)
    return model.eval()


@pytest.mark.parametrize("block,use_se", [("basic", False), ("bottleneck", True)])
def test_classifier_logits_equal_flax(block, use_se, tmp_path):
    kw = dict(CLASSIFIER_KW, block=block, use_se=use_se)
    model = _seeded_classifier(**kw)
    jmodel = JC.FFCResNet(**kw)
    x = np.random.default_rng(6).random((2, 5, 40, 40)).astype(np.float32)
    # the bridge against flax's own variable tree (names and shapes)
    shapes = jax.eval_shape(lambda r: jmodel.init(r, jnp.asarray(x), train=False),
                            jax.random.key(0))
    want_keys = {k: v.shape for k, v in traverse_util.flatten_dict(shapes, sep="/").items()}
    flat = classifier_params_to_jax(model)
    assert {k: v.shape for k, v in flat.items()} == want_keys
    variables = traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables,
                                                                           jnp.asarray(x)))
    carried = TC.FFCResNet(**kw).eval()
    carried.load_state_dict(classifier_params_from_jax(variables, carried.state_dict()))
    with torch.no_grad():
        got = carried(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    # the flat npz round trip
    save_classifier_npz(str(tmp_path / "clf.npz"), model)
    loaded = TC.FFCResNet(**kw).eval()
    load_classifier_npz(str(tmp_path / "clf.npz"), loaded)
    with torch.no_grad():
        np.testing.assert_array_equal(loaded(torch.from_numpy(x)).numpy(), got)


@pytest.mark.parametrize("num_classes", [5, 6])
def test_classifier_labels_and_routed_id_equal_jax(num_classes):
    for de in range(num_classes + 2):
        np.testing.assert_array_equal(TC.degradation_label(de, num_classes),
                                      JC.degradation_label(de, num_classes))
    logits = np.random.default_rng(num_classes).standard_normal((4, num_classes)).astype(np.float32)
    np.testing.assert_array_equal(TC.predicted_task_id(torch.from_numpy(logits)).numpy(),
                                  np.asarray(JC.predicted_task_id(jnp.asarray(logits))))


def test_classifier_router_on_the_cpu():
    route = CLI.make_classifier_router("", "natural_scene", device="cpu")
    cube = np.random.default_rng(2).random((1, 31, 64, 64)).astype(np.float32)
    tid = route(cube)
    assert isinstance(tid, int) and 0 <= tid < 5 and route(cube) == tid


# ---------------------------------------------------------------------------
# the CLI's stdout
# ---------------------------------------------------------------------------

BANNERS = {
    0: "Start gaussian denoise testing sigma=70",
    1: "Start inid gaussian denoise testing sigma=[10, 30, 50, 70]",
    2: "Start destripe testing stripe ratio=[0.05, 0.15]",
    3: "Start deadline denoise testing deadline ratio=[0.05, 0.15]",
    4: "Start impulse denoise testing impulse ratio=[0.1, 0.3, 0.5, 0.7]",
    5: "Start gaussian deblur testing sigma=15",
    6: "Start Motion deblur testing motion radius=(15, 45)",
    7: "Start super-resolution testing downsampling factor=8",
    8: "Start inpaint testing mask ratio =0.9",
    9: "Start dehaze testing haze omega =1.0",
    10: "Start bandmis ratio =0.3",
    11: "Start poisson degradation testing (zero-shot)",
    12: "Start real noise degradation testing",
}
CLI_ARGS = ["--device", "cpu", "--dim", "16", "--num_blocks", "1", "1", "1", "--no_save_images"]


def _check_lines(lines, mode, suffix=" s/cube"):
    label = JCLI.MODE_LABEL[mode](JaxEvalConfig())
    assert len(lines) == 4, lines
    assert lines[0] == BANNERS[mode]
    assert lines[1] == "Total Test HSIs Ids : 1"
    head, tail = lines[2].split(": psnr: ")
    assert head == label and ", ssim: " in tail
    float(tail.split(", ssim: ")[0])
    head, tail = lines[3].split(": sam: ")
    assert head == label and " deg, net time: " in tail and tail.endswith(suffix), lines[3]


@pytest.mark.parametrize("mode", MODES)
def test_cli_stdout_contract(mode, golden_dirs, capsys):
    clean_dir, degrad_dir = golden_dirs
    CLI.main(["--mode", str(mode), "--test_dir", clean_dir, "--test_degrad_dir", degrad_dir]
             + CLI_ARGS)
    _check_lines(capsys.readouterr().out.strip().splitlines(), mode)


def test_cli_auto_task_stdout_contract(golden_dirs, capsys):
    CLI.main(["--mode", "5", "--test_dir", golden_dirs[0], "--auto_task"] + CLI_ARGS)
    _check_lines(capsys.readouterr().out.strip().splitlines(), 5)


def test_cli_mode12_without_degrad_dir(golden_dirs):
    with pytest.raises(SystemExit, match="--test_degrad_dir"):
        CLI.main(["--mode", "12", "--test_dir", golden_dirs[0]] + CLI_ARGS)


def test_cli_pipelined_float16_subprocess(golden_dirs):
    r = subprocess.run(
        [sys.executable, "-m", "mp_hsir_tpu_torch.cli.test_cli", "--mode", "7", "--test_dir",
         golden_dirs[0], "--pipeline", "2", "--upload_dtype", "float16"] + CLI_ARGS,
        cwd=REPO, env=torch_threads.SUBPROCESS_ENV, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    _check_lines(r.stdout.strip().splitlines(), 7, suffix=" s/cube (pipelined x2)")


def test_cli_without_a_card_raises(golden_dirs):
    """No fall back to the CPU: without ``--device cpu`` the CLI needs a card."""
    if torch.cuda.is_available():
        assert CLI.resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        CLI.main(["--mode", "0", "--test_dir", golden_dirs[0], "--no_save_images"])
    with pytest.raises(RuntimeError, match="cuda"):
        CLI.main(["--mode", "0", "--test_dir", golden_dirs[0], "--no_save_images",
                  "--auto_task"])
