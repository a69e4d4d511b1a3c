"""The PyTorch port's training route against the JAX package, on the CPU in
float32 (plain versions of every kernel), tiny configuration (dim 16, 32x32).

* the train-mode L1 loss and every parameter gradient against
  ``jax.value_and_grad`` of the JAX model's jnp path (drop-path off);
* ``train_step`` after 1 and 3 steps against JAX ``make_train_step`` on a
  one-device mesh: parameters within 1e-5, and the learning rate of every
  update equal to the JAX schedule's;
* both also on a tiny 100-band, 7-task model (the remote-sensing preset's
  bands and tasks) at batch 2 with task ids [5, 6] (haze and band-missing,
  which only that preset has);
* schedules and losses against ``mp_hsir_tpu/training``;
* ``save_params_npz`` -> ``params_from_jax`` round trip, and the port's npz
  loading into the JAX package.

Gradient tolerance: 1e-4 of each tensor's max-abs (float32, summation
order). The weights are the JAX init with the TVSP text-query LayerNorm
biases (``prompt*.cross_transformer.norm11.bias``) drawn at random: at their
zero init, LN of the per-pixel ``t * clip_j`` is ``+-LN(t)``, the L2-normalised
queries lose every dependence on the query path, and its gradients are
float32 noise (1e-8) in both frameworks, which Adam turns into +-lr steps.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from mp_hsir_tpu.config import ModelConfig as JaxModelConfig
from mp_hsir_tpu.config import TrainConfig as JaxTrainConfig
from mp_hsir_tpu.models.mp_hsir import MPHSIRNet as JaxNet
from mp_hsir_tpu.models.mp_hsir import init_params
from mp_hsir_tpu.training import losses as jax_losses
from mp_hsir_tpu.training import schedules as jax_sched
from mp_hsir_tpu_torch.checkpoint import params_from_jax, save_params_npz
from mp_hsir_tpu_torch.config import ModelConfig, TrainConfig
from mp_hsir_tpu_torch.models.mp_hsir import build_model
from mp_hsir_tpu_torch.training import losses, schedules
from mp_hsir_tpu_torch.training.trainer import create_train_state, train_step
import torch_threads  # noqa: E402,F401  (one compute thread per process)

TINY = dict(in_channels=5, out_channels=5, dim=16, num_blocks=(1, 1, 1),
            num_refinement_blocks=1, heads=(2, 2, 2), task_classes=6, drop_path_max=0.0)
TINY_RS = dict(TINY, in_channels=100, out_channels=100, task_classes=7)
# (configuration, task ids of the batch's two samples)
FLAGSHIP, REMOTE = (TINY, (0, 3)), (TINY_RS, (5, 6))


def _flat(params):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def _batch(seed, tiny=TINY, tasks=(0, 3), hw=32):
    r = np.random.default_rng(seed)
    clean = r.random((len(tasks), tiny["in_channels"], hw, hw)).astype(np.float32)
    degraded = np.clip(clean + 0.2 * r.standard_normal(clean.shape), 0, 1).astype(np.float32)
    return dict(degraded=degraded, clean=clean, task_id=np.array(tasks, np.int32))


def _init(seed, tiny=TINY):
    """Tiny JAX params, text-query LN biases drawn (see the module note)."""
    params = init_params(JaxModelConfig(**tiny), jax.random.key(seed), sample_hw=32)
    flat = traverse_util.flatten_dict(params, sep="/")
    r = np.random.default_rng(seed)
    for k in flat:
        if k.endswith("cross_transformer/norm11/bias"):
            flat[k] = jnp.asarray(0.5 * r.standard_normal(flat[k].shape), jnp.float32)
    return traverse_util.unflatten_dict(flat, sep="/")


def _port(params, train=True, tiny=TINY):
    model = build_model(ModelConfig(**tiny), device="cpu", train=train)
    model.load_state_dict(params_from_jax(_flat(params), model.state_dict()))
    return model


def _torch_batch(batch):
    return dict(degraded=torch.from_numpy(batch["degraded"]),
                clean=torch.from_numpy(batch["clean"]),
                task_id=torch.from_numpy(batch["task_id"]).long())


def _loss_and_grads_match_jax(tiny, tasks):
    jc = JaxModelConfig(**tiny)
    params = _init(0, tiny)
    batch = _batch(1, tiny, tasks)
    jm = JaxNet(jc)

    def loss_fn(p):
        pred = jm.apply({"params": p}, jnp.asarray(batch["degraded"]),
                        jnp.asarray(batch["task_id"]), deterministic=False,
                        rngs={"droppath": jax.random.key(1)})
        return jax_losses.l1_clamped(pred, jnp.asarray(batch["clean"]))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = _port(params, tiny=tiny)
    tb = _torch_batch(batch)
    loss = losses.l1_clamped(model(tb["degraded"], tb["task_id"]), tb["clean"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    want = params_from_jax(_flat(want_grads))
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for k, g in want.items():
        scale = float(g.abs().max())
        err = float((got[k].grad - g).abs().max())
        assert err <= 1e-4 * scale, f"{k}: {err:.3e} > 1e-4 * {scale:.3e}"


def test_tiny_model_train_loss_and_grads_match_jax():
    _loss_and_grads_match_jax(*FLAGSHIP)


def test_tiny_remote_sensing_train_loss_and_grads_match_jax():
    _loss_and_grads_match_jax(*REMOTE)


@pytest.mark.parametrize("grad_accum,preset", [pytest.param(1, FLAGSHIP, id="1"),
                                               pytest.param(2, FLAGSHIP, id="2"),
                                               pytest.param(1, REMOTE, id="remote_sensing")])
def test_train_step_matches_jax_make_train_step(grad_accum, preset):
    """1 and 3 steps of the port's train step against the JAX train step
    (jnp path, one-device mesh): same parameters within 1e-5 and the same
    learning rate for every optimizer update. The schedule has a 1-epoch
    warmup over 4 epochs of 1 update, so the rate moves every update."""
    from mp_hsir_tpu.parallel.mesh import make_mesh
    from mp_hsir_tpu.training.trainer import create_train_state as jax_state
    from mp_hsir_tpu.training.trainer import make_train_step

    tiny, tasks = preset
    jc = JaxModelConfig(**tiny)
    jtc = JaxTrainConfig(epochs=4, steps_per_epoch=grad_accum, warmup_frac=0.25, lr=1e-4,
                         eta_min=1e-6, patch_size=32, grad_accum=grad_accum, batch_size=2)
    tc = TrainConfig(**{f.name: getattr(jtc, f.name) for f in dataclasses.fields(TrainConfig)})
    js = jax_state(jc, jtc, jax.random.key(0))
    js = js.replace(params=_init(0, tiny))
    step = make_train_step(jc, make_mesh(1, 1, devices=jax.devices()[:1]))
    sched = jax_sched.linear_warmup_cosine_annealing(
        base_lr=jtc.lr, warmup_epochs=int(jtc.warmup_frac * jtc.epochs), max_epochs=jtc.epochs,
        steps_per_epoch=max(jtc.steps_per_epoch // grad_accum, 1), eta_min=jtc.eta_min)
    state = create_train_state(ModelConfig(**tiny), tc, device="cpu",
                               model=_port(js.params, tiny=tiny))
    for i in range(3):
        batch = _batch(10 + i, tiny, tasks)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        js, jloss = step(js, jb, jax.random.key(i))
        loss = train_step(state, _torch_batch(batch))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        if (i + 1) % grad_accum == 0:
            assert state.updates == (i + 1) // grad_accum
            np.testing.assert_allclose(state.last_lr, float(sched(state.updates - 1)), rtol=1e-6)
        if i in (0, 2):
            want = params_from_jax(_flat(js.params))
            got = state.model.state_dict()
            for k, v in want.items():
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5, rtol=0,
                                           err_msg=f"step {i + 1}: {k}")


SCHEDULES = [
    ("linear_warmup_cosine_annealing", (2e-4, 10, 100), dict(steps_per_epoch=3, eta_min=1e-6), 330),
    ("linear_warmup_cosine_annealing", (1e-3, 1, 20), {}, 25),
    ("multi_step_restart", (3e-4, [5, 12]), dict(gamma=0.5, restarts=(0, 8), restart_weights=(1.0, 0.7)), 20),
    ("cosine_annealing_restart", (2e-4, [10, 15]), dict(restart_weights=(1.0, 0.5), eta_min=1e-6), 30),
    ("linear_lr", (3e-4, 40), {}, 40),
    ("cosine_annealing_restart_cyclic", (2e-4, [10, 15, 5]), dict(restart_weights=(1.0, 0.5, 0.25), eta_mins=(1e-6, 1e-7, 0.0)), 31),
    ("linear_warmup_decay", (5, 30), dict(cosine=True), 32),
    ("linear_warmup_decay", (5, 30), dict(cosine=False, linear=True), 32),
    ("linear_warmup_decay", (5, 30), dict(cosine=False), 32),
    ("vibrate", (1e-3, 400), {}, 400),
]


@pytest.mark.parametrize("name,args,kw,steps", SCHEDULES)
def test_schedules_match_jax(name, args, kw, steps):
    want = getattr(jax_sched, name)(*args, **kw)
    got = getattr(schedules, name)(*args, **kw)
    for s in range(steps):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-5, atol=1e-12,
                                   err_msg=f"{name} step {s}")


@pytest.mark.parametrize("name", ["l1_clamped", "l1", "charbonnier", "ssim_loss",
                                  "gan_lsgan", "gan_vanilla"])
def test_losses_match_jax(name):
    r = np.random.default_rng(5)
    a = (r.random((2, 3, 24, 24)) * 1.4 - 0.2).astype(np.float32)
    b = r.random((2, 3, 24, 24)).astype(np.float32)
    if name.startswith("gan"):
        mode = name.split("_")[1]
        want = [jax_losses.gan_loss(jnp.asarray(a), t, mode) for t in (True, False)]
        got = [losses.gan_loss(torch.from_numpy(a), t, mode) for t in (True, False)]
    else:
        want = [getattr(jax_losses, name)(jnp.asarray(a), jnp.asarray(b))]
        got = [getattr(losses, name)(torch.from_numpy(a), torch.from_numpy(b))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-7)


def test_save_params_npz_round_trips_into_both_packages(tmp_path):
    from mp_hsir_tpu.training.checkpoint import load_params_npz as jax_load

    jc = JaxModelConfig(**TINY)
    params = init_params(jc, jax.random.key(2), sample_hw=32)
    model = _port(params, train=False)
    path = str(tmp_path / "port.npz")
    save_params_npz(path, model, dtype=np.float32)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    sd = params_from_jax(flat, model.state_dict())
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    restored = _flat(jax_load(path, params))
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(restored[k], v)
