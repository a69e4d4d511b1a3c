"""The port's training entry point on the CPU: the train pipeline against
the JAX ``TrainPipeline``, the train-state checkpoints, the reference
checkpoint converter against the JAX one, and the train CLI end to end with a
tiny model (dim 16, 32x32 patches).

* Pipeline: the clean batches and task ids before degradation equal JAX's
  bit for bit (both orders come from numpy), for every upload dtype, streaming
  and resident; two runs with one seed are bitwise equal; the resident bank
  covering the store (refresh off) equals streaming; each upload dtype widens
  back as JAX widens it (bitwise) and within its quantisation step of the
  float32 batch; an exception in a producer thread raises in the consumer.
* Reference checkpoint: a reference-keyed state dict built as
  ``tests/test_checkpoint.py`` builds one gives the same tensors and the same
  report through the port's converter as through JAX ``convert_torch_state``.
* CLI: 2 epochs x 2 steps write the log, TensorBoard events, a checkpoint per
  epoch and an npz that the port's eval CLI loads; resuming from epoch 1's
  checkpoint reproduces epoch 2's losses and final weights bit for bit
  (float32).
"""

import json
import re
import threading

import numpy as np
import pytest

import jax
import torch

from mp_hsir_tpu.config import ModelConfig as JaxModelConfig
from mp_hsir_tpu.config import TrainConfig as JaxTrainConfig
from mp_hsir_tpu.data.patch_store import PatchStore as JaxPatchStore
from mp_hsir_tpu.data.train_pipeline import TrainPipeline as JaxPipeline
from mp_hsir_tpu.data.train_pipeline import _dev_widen as jax_widen
from mp_hsir_tpu.data.train_pipeline import _host_shrink as jax_shrink
from mp_hsir_tpu_torch.cli import train_cli
from mp_hsir_tpu_torch.config import ModelConfig, TrainConfig
from mp_hsir_tpu_torch.data.patch_store import PatchStore, PatchStoreWriter
from mp_hsir_tpu_torch.data.train_pipeline import TrainPipeline, _dev_widen, _host_shrink
import torch_threads  # noqa: E402,F401  (one compute thread per process)

DTYPES = ["float32", "float16", "bfloat16", "uint16"]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """10 seeded 6-band 32x32 patches (sources WDC_*); a batch of 4 cycles."""
    path = tmp_path_factory.mktemp("store")
    rng = np.random.default_rng(0)
    with PatchStoreWriter(str(path)) as w:
        for i in range(10):
            w.add(rng.random((6, 32, 32)).astype(np.float32), f"WDC_{i}.mat")
    return str(path)


def _tc(**kw):
    return dict(batch_size=4, seed=3, data_type="natural_scene", **kw)


class _Undegraded:
    """Stands in for the batch degrader: the host draws as before, the
    device batch passed through (the clean batch before degradation)."""

    def __init__(self, degrader):
        self.inner = degrader

    def host_draws(self, rng, de_ids):
        return self.inner.host_draws(rng, de_ids)

    def run(self, gen, clean, order, modes, runs):
        return clean, clean


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_clean_batches_and_task_ids_equal_jax(store, dtype, resident):
    jp = JaxPipeline(JaxPatchStore(store), JaxTrainConfig(**_tc()), target_bands=None,
                     upload_dtype=dtype, resident=resident)
    jp._degrade = jax.jit(lambda k, c, d: (jax_widen(c), jax_widen(c)))
    jp._gather_degrade = jax.jit(lambda k, bank, i, d: (jax_widen(bank[i]),) * 2)
    tp = TrainPipeline(PatchStore(store), TrainConfig(**_tc()), upload_dtype=dtype,
                       resident=resident, device="cpu")
    tp.degrader = _Undegraded(tp.degrader)
    for epoch in range(2):
        pairs = list(zip(jp.epoch(epoch, steps=4), tp.epoch(epoch, steps=4)))
        assert len(pairs) == 4
        for a, b in pairs:
            np.testing.assert_array_equal(b["clean"].numpy(), np.asarray(a["clean"]))
            np.testing.assert_array_equal(b["task_id"].numpy(), np.asarray(a["task_id"]))
            assert b["step_in_epoch"] == a["step_in_epoch"]


def _epochs(pipe, epochs=2, steps=3):
    return [{k: v for k, v in b.items()} for e in range(epochs) for b in pipe.epoch(e, steps)]


def test_two_runs_bitwise_and_resident_equals_streaming(store):
    tc = TrainConfig(**_tc())
    runs = [_epochs(TrainPipeline(PatchStore(store), tc, device="cpu", resident=res))
            for res in (False, False, True)]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            for k in ("degraded", "clean", "task_id"):
                assert torch.equal(a[k], b[k]), k
    assert (runs[0][0]["degraded"] - runs[0][0]["clean"]).abs().max() > 1e-3


@pytest.mark.parametrize("dtype", DTYPES)
def test_upload_dtype_widens_back(dtype):
    x = np.random.default_rng(1).random((2, 3, 16, 16)).astype(np.float32)
    got = _dev_widen(_host_shrink(x, dtype)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_widen(jax.device_put(jax_shrink(
        x, np.dtype(jax.numpy.bfloat16 if dtype == "bfloat16" else dtype))))))
    step = {"float32": 0.0, "float16": 2.0 ** -11, "bfloat16": 2.0 ** -8,
            "uint16": 0.5 / 65535 + 1e-7}[dtype]
    assert np.abs(got - x).max() <= step


class _Failing:
    """A patch store whose gather raises on its second call."""

    def __init__(self, inner):
        self.inner, self.calls = inner, 0

    def __len__(self):
        return len(self.inner)

    def gather(self, idxs):
        self.calls += 1
        if self.calls == 2:
            raise OSError("disk gone")
        return self.inner.gather(idxs)


@pytest.mark.parametrize("resident", [False, True])
def test_producer_exception_raises_in_consumer(store, resident):
    pipe = TrainPipeline(_Failing(PatchStore(store)), TrainConfig(**_tc()), device="cpu",
                         resident=resident, refresh_per_step=2 if resident else 0,
                         bank_patches=4 if resident else None)
    before = set(threading.enumerate())
    with pytest.raises(OSError, match="disk gone"):
        list(pipe.epoch(0, steps=4))
    # the producer thread ends rather than waiting on a full queue
    for t in set(threading.enumerate()) - before:
        t.join(timeout=5)
        assert not t.is_alive()


# ---------------------------------------------------------------------------
# reference checkpoints
# ---------------------------------------------------------------------------

TINY = dict(in_channels=5, out_channels=5, dim=16, num_blocks=(1, 1, 1),
            num_refinement_blocks=1, heads=(2, 2, 2), task_classes=6)


def _reference_state(rng, flat):
    """A reference-keyed torch state dict for flat JAX params, fresh values,
    as tests/test_checkpoint.py:24-56 builds one."""
    sd = {}
    for path, value in flat.items():
        leaf, parent = path[-1], path[-2] if len(path) >= 2 else ""
        key = re.sub(r"blocks_(\d+)\.", r"blocks.\1.", ".".join(path))
        key = re.sub(r"\b(down1_2|down2_3|up3_2|up2_1)\.conv\.", r"\1.body.0.", key)
        v = rng.standard_normal(np.shape(value)).astype(np.float32)
        if leaf == "visual_prompt":
            v = np.transpose(v, (2, 0, 1))[None]
        elif leaf == "text_prompt_learnable":
            v = v[None, :, :, None, None]
        elif leaf == "weight" and v.ndim == 2:
            v = v.T.copy()
        elif leaf == "weight" and v.ndim == 4:
            v = np.transpose(v, (3, 2, 0, 1)).copy()
        elif leaf in ("weight", "bias") and parent in ("norm1", "norm2", "norm11", "norm12"):
            key = key.replace(f"{parent}.{leaf}", f"{parent}.body.{leaf}")
        sd[key] = v
    # the shape filter and the unmatched list
    sd["output.weight"] = np.zeros((7, 7, 3, 3), np.float32)
    sd["nonexistent.module.weight"] = np.zeros((4, 4), np.float32)
    sd["encoder_level1.blocks.0.attn.attn_mask"] = np.zeros((4, 4), np.float32)
    return sd


def test_reference_checkpoint_equals_jax(tmp_path):
    from mp_hsir_tpu.models.mp_hsir import init_params
    from mp_hsir_tpu.training.checkpoint import _flatten
    from mp_hsir_tpu.training.checkpoint import convert_torch_state as jax_convert
    from mp_hsir_tpu_torch.checkpoint import params_from_jax, params_to_jax
    from mp_hsir_tpu_torch.models.mp_hsir import build_model
    from mp_hsir_tpu_torch.training import checkpoint as CK

    jparams = init_params(JaxModelConfig(**TINY), jax.random.key(0), sample_hw=32)
    jflat = _flatten(jparams)
    sd = _reference_state(np.random.default_rng(4), jflat)
    want_params, want_report = jax_convert(sd, jparams)
    want = {"/".join(p): np.asarray(v) for p, v in _flatten(want_params).items()}

    model = build_model(ModelConfig(**TINY), device="cpu")
    model.load_state_dict(params_from_jax({"/".join(p): v for p, v in jflat.items()},
                                          model.state_dict()))
    got, report = CK.convert_torch_state(sd, params_to_jax(model.state_dict()))
    assert report == want_report
    assert report["shape_skipped"] == ["output.weight"]
    assert report["unmatched"] == ["nonexistent.module.weight"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # the file path users hit: a Lightning blob with the net. prefix
    blob = {"state_dict": {"net." + k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()}, "epoch": 3}
    torch.save(blob, str(tmp_path / "ref.ckpt"))
    file_report = CK.load_reference_checkpoint(str(tmp_path / "ref.ckpt"), model, verbose=False)
    assert file_report == want_report
    loaded = params_to_jax(model.state_dict())
    for k in want:
        np.testing.assert_array_equal(loaded[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the CLI end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rs_store(tmp_path_factory):
    """8 seeded 100-band 32x32 patches, sources WDC_* (the remote-sensing
    source filter keeps them)."""
    path = tmp_path_factory.mktemp("rs_store")
    rng = np.random.default_rng(1)
    with PatchStoreWriter(str(path)) as w:
        for i in range(8):
            w.add(rng.random((100, 32, 32)).astype(np.float32), f"WDC_{i}.mat")
    return str(path)


def _cli(store, ckpt_dir, *extra):
    return ["--db_path", store, "--device", "cpu", "--dim", "16", "--compute_dtype", "float32",
            "--batch_size", "2", "--patch_size", "32", "--epochs", "2", "--steps_per_epoch", "2",
            "--log_every", "1", "--ckpt_every_epochs", "1", "--ckpt_dir", str(ckpt_dir), *extra]


def test_cli_end_to_end_and_resume(rs_store, tmp_path):
    from mp_hsir_tpu_torch.cli import test_cli

    full = train_cli.main(_cli(rs_store, tmp_path / "full"))
    losses = [r["train_loss"] for r in full["losses"]]
    assert [r["step"] for r in full["losses"]] == [1, 2, 3, 4] and np.isfinite(losses).all()
    log = [json.loads(line) for line in (tmp_path / "full" / "train_log.jsonl").read_text().splitlines()]
    assert [r["train_loss"] for r in log] == losses and log[-1]["epoch"] == 1
    assert [p.rsplit("/", 1)[-1] for p in full["checkpoints"]] == ["step_00000002",
                                                                   "step_00000004"]
    assert list((tmp_path / "full" / "tb").iterdir())

    resumed = train_cli.main(_cli(rs_store, tmp_path / "resumed", "--ckpt_path",
                                  full["checkpoints"][0]))
    assert [r["step"] for r in resumed["losses"]] == [3, 4]
    assert [r["train_loss"] for r in resumed["losses"]] == losses[2:]
    with np.load(full["params"]) as a, np.load(resumed["params"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    # the port's eval CLI loads the npz (strict: every key and shape)
    import scipy.io as sio

    cubes = tmp_path / "cubes"
    cubes.mkdir()
    sio.savemat(str(cubes / "a.mat"), {"data": np.random.default_rng(2).random(
        (100, 64, 64)).astype(np.float32)})
    test_cli.main(["--mode", "0", "--test_dir", str(cubes), "--ckpt_path", full["params"],
                   "--data_type", "remote_sensing", "--dim", "16", "--device", "cpu",
                   "--no_save_images"])


def test_cli_refuses_mesh_and_missing_card(rs_store, tmp_path):
    """A mesh size below 1 raises; without a card the default device raises,
    on one rank and before a mesh spawns its ranks: --mesh_data 2, and
    --mesh_spatial 2 at the default bf16, which gets past the compute type
    (the bf16 halo tiles shard the rows) to the missing card."""
    with pytest.raises(SystemExit, match="at least 1"):
        train_cli.main(["--db_path", rs_store, "--mesh_data", "0"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_cli.main(["--db_path", rs_store, "--ckpt_dir", str(tmp_path)])
        for mesh in (["--mesh_data", "2"], ["--mesh_spatial", "2"]):
            with pytest.raises(RuntimeError, match="cuda"):
                train_cli.main(["--db_path", rs_store, *mesh, "--ckpt_dir", str(tmp_path)])


@pytest.fixture(scope="module")
def rs_store64(tmp_path_factory):
    """4 seeded 100-band 64x64 patches (two row shards of 32 rows each)."""
    path = tmp_path_factory.mktemp("rs_store64")
    rng = np.random.default_rng(2)
    with PatchStoreWriter(str(path)) as w:
        for i in range(4):
            w.add(rng.random((100, 64, 64)).astype(np.float32), f"WDC_{i}.mat")
    return str(path)


@pytest.mark.parametrize("mesh", [("--mesh_data", "2"), ("--mesh_spatial", "2")],
                         ids=["data2", "spatial2"])
def test_cli_mesh_matches_one_rank(mesh, rs_store, rs_store64, tmp_path, monkeypatch):
    """The CLI on a 2 x 1 or 1 x 2 mesh (two gloo ranks it spawns on the
    CPU, float32, 2 steps) against one rank on the same store and seed: the
    same logged steps, the parameters bitwise equal on both ranks at the
    end, rank 0's checkpoint and npz. 1 x 2: the losses within 1e-4 of one
    rank's (the same samples and drop-path draws, rows split). 2 x 1: each
    data group draws its own drop-path scales (the seed folded by its
    index, as JAX folds its key), so the losses are those of other masks:
    within 1e-2 of one rank's."""
    for k, v in torch_threads.SUBPROCESS_ENV.items():  # the spawned ranks: one thread each
        if k.endswith("_NUM_THREADS"):
            monkeypatch.setenv(k, v)
    spatial = mesh[0] == "--mesh_spatial"
    store = rs_store64 if spatial else rs_store
    extra = ["--epochs", "1"] + (["--patch_size", "64"] if spatial else [])
    one = train_cli.main(_cli(store, tmp_path / "one", *extra))
    two = train_cli.main(_cli(store, tmp_path / "two", *extra, *mesh))
    assert [r["step"] for r in two["losses"]] == [r["step"] for r in one["losses"]] == [1, 2]
    np.testing.assert_allclose([r["train_loss"] for r in two["losses"]],
                               [r["train_loss"] for r in one["losses"]],
                               atol=1e-4 if spatial else 1e-2, rtol=0)
    assert two["same_params"] and two["mesh"] == ((1, 2) if spatial else (2, 1))
    assert [p.rsplit("/", 1)[-1] for p in two["checkpoints"]] == ["step_00000002"]
    assert (tmp_path / "two" / "params_final.npz").exists()


def test_cli_flags_are_train_py_s():
    """Every flag of the JAX entry point, with its default, plus --device
    and --use_kernels in place of --use_pallas."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "jax_train", pathlib.Path(__file__).resolve().parent.parent / "train.py")
    jax_train = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_train)
    want = {a.dest: a.default for a in jax_train.build_parser()._actions}
    got = {a.dest: a.default for a in train_cli.build_parser()._actions}
    want.pop("use_pallas")
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == {"device", "use_kernels"}
    assert got["device"] == "cuda" and got["use_kernels"] is True
