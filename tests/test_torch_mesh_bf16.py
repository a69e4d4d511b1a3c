"""The row-sharded bf16 train step of the PyTorch port (``--mesh_spatial M``
at the train CLI's default ``--compute_dtype bfloat16``) on the CPU:

* the plain bf16 halo versions of the spectral stats and apply launches
  (K7a / K7b forward) against the JAX package's shard kernels ``_sp0_call``
  / ``_sp1_call`` in interpret mode with bf16 inputs, at every edge-flag
  combination, with and without the LayerNorm, with the gate and drop-path
  scale, the per-pixel gate map (the apply's gate operand, as JAX's
  ``gate_map``) and the PromptFusion entry;
* their plain bf16 backwards (K10a / K10b with the halo cotangents) against
  ``jax.vjp`` of ``sp0_sharded`` / ``sp1_sharded`` in bf16;
* one tiny-model bf16 step on a 1 x 2 mesh of gloo ranks spawned on this
  machine, a shifted block included, against JAX's ``make_train_step(mc,
  make_mesh(1, 2))`` in bf16 and against the port's one-rank bf16 step (the
  loss and every parameter's gradient concatenated).

Tolerances: the kernel-level cases take the bf16 kernel-vs-plain bound of
the port's other bf16 cases (``tests/test_torch_stats_bwd.py``,
``tests/test_torch_apply_bwd.py``): 3e-2 of each output's largest magnitude;
the step's are STEP_GRAD_TOL, STEP_JAX_GRAD_TOL and STEP_LOSS_RTOL. The
halo tiles themselves are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phases 15 and 16)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_threads  # noqa: E402,F401  (one compute thread per process)
from mp_hsir_tpu.ops.pallas_attention import _sp0_call, _sp1_call
from mp_hsir_tpu_torch.ops.kernels.spectral import (
    Halo, spectral_apply, spectral_apply_plain, spectral_stats, spectral_stats_plain,
)
from test_torch_mesh_train import (
    EDGE_IDS, EDGES, SP1_EXTRA, _close, _jax_weights, _port_weights, _shard as _bwd_shard,
    _sp0_vjp, _sp1_vjp,
)
from torch_port_inputs import normal, rng, tensor, uniform

BF16_TOL = 3e-2  # of each output's largest magnitude (the port's bf16 cases)
BF16 = torch.bfloat16


def _bf(a):
    """A float32 array rounded to bf16, as a float32 array (both sides get
    the same values)."""
    return tensor(a).to(BF16).float().numpy()


def _fwd_shard(seed, c, c2=0):
    """A 16 x 16 bf16 shard of cat(x, x2) (C = c + c2), its halo rows and
    operands, values already bf16."""
    r = rng(seed)
    cc = c + c2
    d = dict(x=normal(r, (1, 16, 16, c)), x2=normal(r, (1, 16, 16, c2)) if c2 else None,
             top=normal(r, (1, 1, 16, cc)), bot=normal(r, (1, 1, 16, cc)),
             gate=normal(r, (1, 2, 2, cc), 0.5), gmap=normal(r, (1, 16, 16, cc), 0.5),
             short=normal(r, (1, 16, 16, cc)))
    d = {k: None if v is None else _bf(v) for k, v in d.items()}
    d.update(wqkv=uniform(r, (cc, 3 * cc), cc), wdw=uniform(r, (9, 3 * cc), 9),
             ln_w=1 + normal(r, (cc,), 0.1), ln_b=normal(r, (cc,), 0.1),
             comb=normal(r, (1, cc, cc), cc ** -0.5), dp=np.array([1.25], np.float32))
    d["wqkv_t"] = tensor(d["wqkv"].T.reshape(3 * cc, cc, 1, 1))
    d["wdw_t"] = tensor(d["wdw"].T.reshape(3 * cc, 1, 3, 3))
    return d


def _b(a):
    return tensor(a).to(BF16)


def _jb(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _jax_fwd_args(d, edges):
    x = d["x"] if d["x2"] is None else np.concatenate([d["x"], d["x2"]], -1)
    return (_jb(x), _jb(d["top"]), _jb(d["bot"]), jnp.asarray(np.array(edges, np.int32)),
            jnp.asarray(d["wqkv"]), jnp.asarray(d["wdw"]))


def _near(got, want, what=""):
    """max |got - want| within BF16_TOL of max |want| (bf16 compared in
    float32)."""
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    _close(got, np.asarray(want, np.float32), BF16_TOL, what)


@pytest.mark.parametrize("ln", [False, True], ids=["raw", "ln"])
@pytest.mark.parametrize("edges", EDGES, ids=EDGE_IDS)
def test_stats_halo_bf16_plain_matches_jax_sp0(edges, ln):
    """spectral_stats_plain on a bf16 shard with its bf16 halo rows ==
    _sp0_call in bf16 (interpret mode): the Gram and both norms."""
    d = _fwd_shard(51, 16)
    kw = dict(ln_w=tensor(d["ln_w"]), ln_b=tensor(d["ln_b"])) if ln else {}
    got = spectral_stats_plain(_b(d["x"]), d["wqkv_t"], d["wdw_t"], 2,
                               halo=Halo(_b(d["top"]), _b(d["bot"]), *edges), **kw)
    want = _sp0_call(*_jax_fwd_args(d, edges), jnp.asarray(d["ln_w"]) if ln else None,
                     jnp.asarray(d["ln_b"]) if ln else None, num_heads=2, eps=1e-5,
                     interpret=True)
    for i, (g, w) in enumerate(zip(got, want)):
        _near(g, w, f"output {i}")


@pytest.mark.parametrize("variant", ["gate_dp", "gate_map", "fusion"])
@pytest.mark.parametrize("edges", EDGES, ids=EDGE_IDS)
def test_apply_halo_bf16_plain_matches_jax_sp1(edges, variant):
    """spectral_apply_plain on a bf16 shard with its bf16 halo rows ==
    _sp1_call in bf16 (interpret mode): the PGSSTB epilogue with per-window
    gates, a shortcut and the drop-path scale; a shifted block's per-pixel
    gate map with a shortcut; the PromptFusion entry
    cat(x, x2) with the LayerNorm and the residual."""
    d = _fwd_shard(52, 16, c2=16 if variant == "fusion" else 0)
    x = _b(d["x"])
    halo = Halo(_b(d["top"]), _b(d["bot"]), *edges)
    comb, wq, wd = tensor(d["comb"]), d["wqkv_t"], d["wdw_t"]
    jargs = _jax_fwd_args(d, edges) + (jnp.asarray(d["comb"]),)
    none4 = (None, None, None, None)
    if variant == "gate_dp":
        got = spectral_apply_plain(x, comb, wq, wd, gate=_b(d["gate"]), shortcut=_b(d["short"]),
                                   dp_scale=tensor(d["dp"]), halo=halo)
        want = _sp1_call(*jargs, None, None, _jb(d["gate"]), None, _jb(d["short"]),
                         jnp.asarray(d["dp"]), num_heads=2, eps=1e-5, residual=False,
                         interpret=True)
    elif variant == "gate_map":
        got = spectral_apply_plain(x, comb, wq, wd, gate=_b(d["gmap"]), shortcut=_b(d["short"]),
                                   halo=halo)
        want = _sp1_call(*jargs, None, None, None, _jb(d["gmap"]), _jb(d["short"]), None,
                         num_heads=2, eps=1e-5, residual=False, interpret=True)
    else:
        got = spectral_apply_plain(x, comb, wq, wd, x2=_b(d["x2"]), ln_w=tensor(d["ln_w"]),
                                   ln_b=tensor(d["ln_b"]), residual=True, halo=halo)
        want = _sp1_call(*jargs, jnp.asarray(d["ln_w"]), jnp.asarray(d["ln_b"]), *none4,
                         num_heads=2, eps=1e-5, residual=True, interpret=True)
    assert got.dtype == BF16
    _near(got, want)


def _bwd_inputs(seed):
    """test_torch_mesh_train's shard with its activations rounded to bf16."""
    d = _bwd_shard(seed)
    for k in ("x", "top", "bot", "gate", "gmap", "short", "dy"):
        d[k] = _bf(d[k])
    return d


def _bleaf(a):
    return _b(a).requires_grad_()


def _check_halo_grads(top, bot, want, edges):
    for g, w, edge, name in ((top.grad, want[1], edges[0], "dtop"),
                             (bot.grad, want[2], edges[1], "dbot")):
        if edge:
            assert g is None or not g.abs().max(), name
            np.testing.assert_array_equal(np.asarray(w, np.float32), 0)
        else:
            assert g.dtype == BF16, name
            _near(g, w, name)


@pytest.mark.parametrize("ln", [False, True], ids=["raw", "ln"])
@pytest.mark.parametrize("edges", EDGES, ids=EDGE_IDS)
def test_stats_halo_bf16_backward_matches_jax_sp0_vjp(edges, ln):
    """K10a's plain bf16 backward through the Function (dx, d top, d bottom,
    the q|k weights, the LayerNorm) == jax.vjp of sp0_sharded in bf16."""
    d = _bwd_inputs(53)
    c = 16
    x, top, bot = _bleaf(d["x"]), _bleaf(d["top"]), _bleaf(d["bot"])
    wq, wd = _port_weights(d)
    lnw, lnb = (tensor(d["ln_w"]).requires_grad_(), tensor(d["ln_b"]).requires_grad_()) if ln \
        else (None, None)
    out = spectral_stats(x, wq, wd, 2, ln_w=lnw, ln_b=lnb, halo=Halo(top, bot, *edges))
    torch.autograd.backward(out, [tensor(d[k]) for k in ("dgram", "dnq", "dnk")])

    args = [_jb(d[k]) for k in ("x", "top", "bot")]
    args += [jnp.asarray(d["wqkv"]), jnp.asarray(d["wdw"])]
    args += [jnp.asarray(d["ln_w"]), jnp.asarray(d["ln_b"])] if ln else [None, None]
    want = _sp0_vjp()(jnp.asarray(np.array(edges, np.int32)),
                      tuple(jnp.asarray(d[k]) for k in ("dgram", "dnq", "dnk")), *args)
    assert x.grad.dtype == BF16
    _near(x.grad, want[0], "dx")
    _check_halo_grads(top, bot, want, edges)
    gwq, gwd = _jax_weights(wq.grad, wd.grad, c)
    _near(gwq, want[3], "dwqkv")
    _near(gwd, want[4], "dwdw")
    if ln:
        _near(lnw.grad, want[5], "dln_w")
        _near(lnb.grad, want[6], "dln_b")


@pytest.mark.parametrize("variant", ["ln_residual", "gate_dp", "gate_map_dp"])
@pytest.mark.parametrize("edges", EDGES, ids=EDGE_IDS)
def test_apply_halo_bf16_backward_matches_jax_sp1_vjp(edges, variant):
    """K10b's plain bf16 backward through the Function == jax.vjp of
    sp1_sharded in bf16: PromptFusion's LayerNorm + residual; the PGSSTB
    epilogue with per-window gates, shortcut and drop-path scale; a shifted
    block's gate map with shortcut and drop-path. dx, d top, d bottom, the v
    weights, comb and every
    epilogue input."""
    d = _bwd_inputs(54)
    c = 16
    x, top, bot = _bleaf(d["x"]), _bleaf(d["top"]), _bleaf(d["bot"])
    comb = tensor(d["comb"]).requires_grad_()
    wq, wd = _port_weights(d)
    halo = Halo(top, bot, *edges)
    opt = {}
    if variant == "ln_residual":
        lnw, lnb = tensor(d["ln_w"]).requires_grad_(), tensor(d["ln_b"]).requires_grad_()
        y = spectral_apply(x, comb, wq, wd, ln_w=lnw, ln_b=lnb, residual=True, halo=halo)
        opt = dict(ln_w=lnw, ln_b=lnb)
    else:
        short, dp = _bleaf(d["short"]), tensor(d["dp"]).requires_grad_()
        opt = dict(short=short, dp=dp)
        if variant == "gate_dp":
            gate = _bleaf(d["gate"])
            opt["gate"] = gate
            y = spectral_apply(x, comb, wq, wd, gate=gate, shortcut=short, dp_scale=dp, halo=halo)
        else:
            gmap = _bleaf(d["gmap"])
            opt["gmap"] = gmap
            y = spectral_apply(x, comb, wq, wd, gate=gmap, shortcut=short, dp_scale=dp, halo=halo)
    y.backward(_b(d["dy"]))

    names = ["x", "top", "bot", "wqkv", "wdw", "comb"]
    extra = SP1_EXTRA[variant]
    act = ("x", "top", "bot", "gate", "gmap", "short")
    want = _sp1_vjp(variant)(jnp.asarray(np.array(edges, np.int32)), _jb(d["dy"]),
                             *[_jb(d[k]) if k in act else jnp.asarray(d[k])
                               for k in names + extra])
    assert x.grad.dtype == BF16
    _near(x.grad, want[0], "dx")
    _check_halo_grads(top, bot, want, edges)
    gwq, gwd = _jax_weights(wq.grad, wd.grad, c)
    _near(gwq, want[3], "dwqkv")
    _near(gwd, want[4], "dwdw")
    _near(comb.grad, want[5], "dcomb")
    for n, w in zip(extra, want[6:]):
        _near(opt[n].grad, w, f"d{n}")


# --- the tiny model's bf16 step over spawned gloo ranks ----------------------

# the tiny model with two blocks at its first level, so that the step runs a
# shifted block (the gate map) on the mesh
STEP_TINY = dict(num_blocks=(2, 1, 1), compute_dtype="bfloat16")
# the bf16 1 x 2 step's gradients, every parameter's concatenated,
# norm-wise: against the port's one-rank bf16 step (the plain versions on
# both sides; read 6.7e-4) within STEP_GRAD_TOL, against JAX's bf16 1 x 2
# step (read 2.3e-2: JAX rounds at other points outside the kernels, and
# its one-device bf16 step reads as far from the port's) within
# STEP_JAX_GRAD_TOL; the loss against JAX's (read 1.3e-6) and the one
# rank's (read 0) within STEP_LOSS_RTOL
STEP_GRAD_TOL = 5e-3
STEP_JAX_GRAD_TOL = 5e-2
STEP_LOSS_RTOL = 1e-5


def _grad_capture():
    """An optax transformation whose state after an update is the update's
    gradients (and whose updates are zero): JAX's averaged gradients out of
    make_train_step's state."""
    import optax

    def update(grads, state, params=None):
        return jax.tree.map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p), update)


def test_train_step_bf16_on_1x2_matches_jax_and_one_rank():
    """One bf16 step of make_train_step on a 1 x 2 mesh of gloo ranks (batch
    2 x 5 bands x 64 x 64, 32 rows a rank; drop-path off; a shifted block
    at the first level): the loss within STEP_LOSS_RTOL of JAX
    make_train_step(mc, make_mesh(1, 2)) in bf16 on the same parameters and
    batch and of the port's one rank; the averaged gradients, every
    parameter's concatenated, within STEP_JAX_GRAD_TOL (norm-wise) of JAX's
    and within STEP_GRAD_TOL of the port's one-rank bf16 step; the
    parameters bitwise equal on both ranks."""
    from flax import traverse_util

    from mp_hsir_tpu.config import ModelConfig as JaxModelConfig
    from mp_hsir_tpu.parallel.mesh import make_mesh as jax_mesh
    from mp_hsir_tpu.training.trainer import make_train_step as jax_step
    from mp_hsir_tpu_torch.checkpoint import params_from_jax
    from mp_hsir_tpu_torch.config import TrainConfig
    from mp_hsir_tpu_torch.models.mp_hsir import build_model
    from mp_hsir_tpu_torch.training.trainer import create_train_state, train_step
    from test_torch_mesh_train import _spawn_async, _train_setup
    from test_torch_train import TINY, _batch
    from torch_mesh_ranks import train_step_rank

    if len(jax.devices()) < 2:
        pytest.skip("JAX's 1 x 2 step needs 2 devices")
    tiny = dict(TINY, **STEP_TINY)
    js, cfg, tc, state = _train_setup(tiny)
    batch = _batch(13, tiny, (0, 3), hw=64)
    pending = _spawn_async(train_step_rank, 2, cfg, dict(tc, mesh=(1, 2)), state, [batch], [0],
                           True)
    cap = _grad_capture()
    js = js.replace(tx=cap, opt_state=cap.init(js.params))
    js, jloss = jax_step(JaxModelConfig(**tiny), jax_mesh(1, 2))(
        js, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
    jgrads = params_from_jax({k: np.asarray(v) for k, v in
                              traverse_util.flatten_dict(js.opt_state, sep="/").items()})
    model = build_model(cfg, device="cpu", train=True)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    st = create_train_state(cfg, TrainConfig(**tc), device="cpu", model=model)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tb["task_id"] = tb["task_id"].long()
    grads = {}
    opt_step = st.optimizer.step

    def capture():
        grads.update({k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None})
        opt_step()

    st.optimizer.step = capture
    one_loss = float(train_step(st, tb, torch.Generator().manual_seed(0)))
    got = pending.result()
    assert got["same"]
    assert set(got["grads"]) == set(grads)
    keys = sorted(grads)
    mesh = np.concatenate([got["grads"][k].ravel() for k in keys])
    one = np.concatenate([grads[k].numpy().ravel() for k in keys])
    jax_flat = np.concatenate([jgrads[k].numpy().ravel() for k in keys])
    err = np.linalg.norm(mesh - one) / np.linalg.norm(one)
    err_jax = np.linalg.norm(mesh - jax_flat) / np.linalg.norm(jax_flat)
    np.testing.assert_allclose(got["losses"][0], float(jloss), rtol=STEP_LOSS_RTOL)
    np.testing.assert_allclose(got["losses"][0], one_loss, rtol=STEP_LOSS_RTOL)
    assert err_jax <= STEP_JAX_GRAD_TOL, err_jax
    assert err <= STEP_GRAD_TOL, err
