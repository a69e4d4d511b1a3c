"""The row- and data-sharded train step of the PyTorch port
(``--mesh_data N --mesh_spatial M`` on the train CLI) on the CPU:

* the plain backwards of the spectral stats and apply launches on a shard
  with its halo rows (K10a / K10b with their halo cotangents) against
  ``jax.vjp`` of the JAX package's ``sp0_sharded`` / ``sp1_sharded`` in
  interpret mode: dx, d halo top, d halo bottom and the weights, at every
  edge combination, with and without the LayerNorm, with the gate, the
  shifted block's gate map (folded into the shortcut by the port), the
  shortcut and the drop-path scale (1e-5 of the largest magnitude);
* over gloo ranks spawned on this machine (``tests/torch_mesh_ranks.py``):
  each differentiable collective's backward against the unsharded autograd,
  the sharded PGSSTB's gradients (shifted and unshifted) against JAX's
  sharded VJP, one tiny train step on a 2 x 2 mesh against JAX's
  ``make_train_step(mc, make_mesh(2, 2))`` and, with drop-path on, the
  1 x 2 step against the one-rank port step.

The halo backward kernels themselves are held to these plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 16)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_threads  # noqa: E402,F401  (one compute thread per process)
from mp_hsir_tpu.ops.pallas_vjp import sp0_sharded, sp1_sharded
from mp_hsir_tpu_torch.ops.kernels.spectral import Halo, spectral_apply, spectral_stats
from mp_hsir_tpu_torch.parallel import distributed
from torch_port_inputs import normal, rng, tensor, uniform

EDGES = [(True, True), (True, False), (False, True), (False, False)]
EDGE_IDS = lambda e: f"edge{int(e[0])}{int(e[1])}"  # noqa: E731
SPAWN_TIMEOUT_S = 120  # each collective's limit in a spawned run


def _spawn_async(fn, n, *args):
    """distributed.spawn of gloo ranks on the CPU in a thread of this
    process, so that the JAX reference compiles meanwhile; ``.result()``
    is rank 0's return value. Each collective has a time limit."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(1)
    fut = pool.submit(distributed.spawn, fn, n, *args, device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    pool.shutdown(wait=False)
    return fut


def _close(got, want, rel, what=""):
    """max |got - want| within ``rel`` of max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: max err {err:.3g} > {rel} x {scale:.3g}"


def _shard(seed, c=16):
    """A 16 x 16 shard, its halo rows, weights (JAX layouts) and output
    cotangents."""
    r = rng(seed)
    return dict(x=normal(r, (1, 16, 16, c)), top=normal(r, (1, 1, 16, c)),
                bot=normal(r, (1, 1, 16, c)), wqkv=uniform(r, (c, 3 * c), c),
                wdw=uniform(r, (9, 3 * c), 9), ln_w=1 + normal(r, (c,), 0.1),
                ln_b=normal(r, (c,), 0.1), comb=normal(r, (1, c, c), c ** -0.5),
                gate=normal(r, (1, 2, 2, c), 0.5), gmap=normal(r, (1, 16, 16, c), 0.5),
                short=normal(r, (1, 16, 16, c)), dp=np.array([1.25], np.float32),
                dgram=normal(r, (1, c, c // 2)), dnq=normal(r, (1, 2, c // 2)),
                dnk=normal(r, (1, 2, c // 2)), dy=normal(r, (1, 16, 16, c)))


def _leaf(a):
    return tensor(a).requires_grad_()


def _port_weights(d):
    c = d["x"].shape[-1]
    wq = _leaf(d["wqkv"].T.reshape(3 * c, c, 1, 1))
    wd = _leaf(d["wdw"].T.reshape(3 * c, 1, 3, 3))
    return wq, wd


def _jax_weights(g_wq, g_wd, c):
    """The port's weight gradients in JAX's (C, 3C) and (9, 3C) layouts."""
    return g_wq.reshape(3 * c, c).T, g_wd.reshape(3 * c, 9).T


def _edge(edges):
    return jnp.asarray(np.array(edges, np.int32))


@functools.lru_cache(maxsize=None)
def _sp0_vjp():
    """jax.vjp of sp0_sharded, jitted once for every edge combination (the
    flags are an argument): (edge, cotangents, x, top, bot, wqkv, wdw,
    ln_w, ln_b) -> the inputs' cotangents."""
    def run(edge, cots, *args):
        f = functools.partial(_sp0, edge)
        return jax.vjp(f, *args)[1](cots)

    def _sp0(edge, x, top, bot, wqkv, wdw, ln_w, ln_b):
        return sp0_sharded(x, top, bot, edge, wqkv, wdw, ln_w, ln_b, num_heads=2, eps=1e-5,
                           interpret=True)

    return jax.jit(run)


# the epilogue inputs of each sp1 variant, in sp1_sharded's names
SP1_EXTRA = {"ln_residual": ["ln_w", "ln_b"], "gate_dp": ["gate", "short", "dp"],
             "gate_map_dp": ["gmap", "short", "dp"]}
SP1_NAMES = dict(ln_w="ln_w", ln_b="ln_b", gate="gate", gmap="gate_map", short="shortcut",
                 dp="dp_scale")


@functools.lru_cache(maxsize=None)
def _sp1_vjp(variant):
    """jax.vjp of sp1_sharded with ``variant``'s epilogue, jitted once for
    every edge combination: (edge, dy, x, top, bot, wqkv, wdw, comb,
    *epilogue inputs) -> the inputs' cotangents."""
    extra = SP1_EXTRA[variant]

    def _sp1(edge, x, top, bot, wqkv, wdw, comb, *rest):
        kw = dict(ln_w=None, ln_b=None, gate=None, gate_map=None, shortcut=None, dp_scale=None)
        kw.update({SP1_NAMES[n]: v for n, v in zip(extra, rest)})
        return sp1_sharded(x, top, bot, edge, wqkv, wdw, comb, kw["ln_w"], kw["ln_b"], kw["gate"],
                           kw["gate_map"], kw["shortcut"], kw["dp_scale"], num_heads=2, eps=1e-5,
                           residual=variant == "ln_residual", interpret=True)

    def run(edge, dy, *args):
        return jax.vjp(functools.partial(_sp1, edge), *args)[1](dy)

    return jax.jit(run)


@pytest.mark.parametrize("ln", [False, True], ids=["raw", "ln"])
@pytest.mark.parametrize("edges", EDGES, ids=EDGE_IDS)
def test_stats_halo_backward_matches_jax_sp0_vjp(edges, ln):
    """K10a's plain backward through the Function (dx, d top, d bottom, the
    q|k weights, the LayerNorm) == jax.vjp of sp0_sharded."""
    d = _shard(31)
    c = 16
    x, top, bot = _leaf(d["x"]), _leaf(d["top"]), _leaf(d["bot"])
    wq, wd = _port_weights(d)
    lnw, lnb = (_leaf(d["ln_w"]), _leaf(d["ln_b"])) if ln else (None, None)
    out = spectral_stats(x, wq, wd, 2, ln_w=lnw, ln_b=lnb, halo=Halo(top, bot, *edges))
    torch.autograd.backward(out, [tensor(d[k]) for k in ("dgram", "dnq", "dnk")])

    args = [jnp.asarray(d[k]) for k in ("x", "top", "bot", "wqkv", "wdw")]
    args += [jnp.asarray(d["ln_w"]), jnp.asarray(d["ln_b"])] if ln else [None, None]
    want = _sp0_vjp()(_edge(edges), tuple(jnp.asarray(d[k]) for k in ("dgram", "dnq", "dnk")),
                      *args)
    _close(x.grad, want[0], 1e-5, "dx")
    for g, w, edge, name in ((top.grad, want[1], edges[0], "dtop"),
                             (bot.grad, want[2], edges[1], "dbot")):
        if edge:
            assert g is None or not g.abs().max(), name
            np.testing.assert_array_equal(np.asarray(w), 0)
        else:
            _close(g, w, 1e-5, name)
    gwq, gwd = _jax_weights(wq.grad, wd.grad, c)
    _close(gwq, want[3], 1e-5, "dwqkv")
    _close(gwd, want[4], 1e-5, "dwdw")
    if ln:
        _close(lnw.grad, want[5], 1e-5, "dln_w")
        _close(lnb.grad, want[6], 1e-5, "dln_b")


@pytest.mark.parametrize("variant", ["ln_residual", "gate_dp", "gate_map_dp"])
@pytest.mark.parametrize("edges", EDGES, ids=EDGE_IDS)
def test_apply_halo_backward_matches_jax_sp1_vjp(edges, variant):
    """K10b's plain backward through the Function == jax.vjp of
    sp1_sharded: PromptFusion's LayerNorm + residual; the PGSSTB epilogue
    with per-window gates, shortcut and drop-path scale; a shifted block's
    per-pixel gate map with shortcut and drop-path, which the port folds
    into the shortcut (shortcut + dp x gate_map, autograd through the
    fold). dx, d top, d bottom, the v weights, comb and every epilogue
    input."""
    d = _shard(32)
    c = 16
    x, top, bot, comb = _leaf(d["x"]), _leaf(d["top"]), _leaf(d["bot"]), _leaf(d["comb"])
    wq, wd = _port_weights(d)
    halo = Halo(top, bot, *edges)
    opt = {}
    if variant == "ln_residual":
        lnw, lnb = _leaf(d["ln_w"]), _leaf(d["ln_b"])
        y = spectral_apply(x, comb, wq, wd, ln_w=lnw, ln_b=lnb, residual=True, halo=halo)
        opt = dict(ln_w=lnw, ln_b=lnb)
    else:
        short, dp = _leaf(d["short"]), _leaf(d["dp"])
        opt = dict(short=short, dp=dp)
        if variant == "gate_dp":
            gate = _leaf(d["gate"])
            opt["gate"] = gate
            y = spectral_apply(x, comb, wq, wd, gate=gate, shortcut=short, dp_scale=dp, halo=halo)
        else:
            gmap = _leaf(d["gmap"])
            opt["gmap"] = gmap
            folded = short + dp.reshape(1, 1, 1, 1) * x * gmap
            y = spectral_apply(x, comb, wq, wd, shortcut=folded, dp_scale=dp, halo=halo)
    y.backward(tensor(d["dy"]))

    names = ["x", "top", "bot", "wqkv", "wdw", "comb"]
    extra = SP1_EXTRA[variant]
    want = _sp1_vjp(variant)(_edge(edges), jnp.asarray(d["dy"]),
                             *[jnp.asarray(d[k]) for k in names + extra])
    _close(x.grad, want[0], 1e-5, "dx")
    for g, w, edge, name in ((top.grad, want[1], edges[0], "dtop"),
                             (bot.grad, want[2], edges[1], "dbot")):
        if edge:
            assert g is None or not g.abs().max(), name
            np.testing.assert_array_equal(np.asarray(w), 0)
        else:
            _close(g, w, 1e-5, name)
    gwq, gwd = _jax_weights(wq.grad, wd.grad, c)
    _close(gwq, want[3], 1e-5, "dwqkv")
    _close(gwd, want[4], 1e-5, "dwdw")
    _close(comb.grad, want[5], 1e-5, "dcomb")
    for n, w in zip(extra, want[6:]):
        _close(opt[n].grad, w, 1e-5, f"d{n}")


# --- spawned gloo ranks ------------------------------------------------------

def test_collective_backwards_match_unsharded_autograd():
    """Over 4 gloo ranks, each rank's loss sum(out * cot) over its rows: the
    gathered input gradients (and the weight gradients summed over the
    ranks) of roll_hw by (-4, -4) and (4, 4) (ring_next / ring_prev), the
    halo-padded 3x3 conv (edge_rows, nothing through the ring's wrap), a
    conv over the extended rows (extend_rows), gather_rows (its loss over
    the whole map on every rank: 4 x the unsharded gradient),
    CrossAttention's summed statistics (psum) and the sharded spectral
    attention with LayerNorm and residual (halo rows, psum, the halo
    cotangents of K10a / K10b's plain backwards) == the unsharded
    autograd."""
    from mp_hsir_tpu_torch.models.layers import CrossAttention, SpectralAttention
    from mp_hsir_tpu_torch.ops.conv import conv2d
    from mp_hsir_tpu_torch.ops.kernels.spectral import spectral_apply as apply_
    from mp_hsir_tpu_torch.ops.window import roll_hw
    from torch_mesh_ranks import collective_grads_rank

    r = rng(41)
    x = normal(r, (1, 32, 8, 4))
    w_conv = normal(r, (8, 4, 3, 3), 0.1)
    torch.manual_seed(1)
    cross = CrossAttention(8, 2)
    ca = dict(c=8, state={k: v.detach().numpy() for k, v in cross.state_dict().items()},
              q=normal(r, (1, 32, 8, 8)), kv=normal(r, (1, 32, 8, 8)))
    sa = SpectralAttention(8, 2)
    sp = dict(x=normal(r, (1, 32, 8, 8)), wqkv=sa.qkv.weight.detach().numpy(),
              wdw=sa.qkv_dwconv.weight.detach().numpy(), temp=1 + normal(r, (2, 1, 1), 0.2),
              wout=sa.project_out.weight.detach().numpy(), ln_w=1 + normal(r, (8,), 0.1),
              ln_b=normal(r, (8,), 0.1))
    cots = {k: normal(r, s) for k, s in (("roll-4", (1, 32, 8, 4)), ("roll4", (1, 32, 8, 4)),
                                         ("conv", (1, 32, 8, 8)), ("extend", (1, 32, 8, 8)),
                                         ("gather", (1, 32, 8, 4)), ("cross", (1, 32, 8, 8)),
                                         ("spectral", (1, 32, 8, 8)))}
    got = distributed.spawn(collective_grads_rank, 4, x, w_conv, ca, sp, cots, device="cpu",
                            timeout_s=SPAWN_TIMEOUT_S)

    def want(name, fn, *inputs, scale=1.0):
        leaves = [tensor(a).requires_grad_() for a in inputs]
        (fn(*leaves) * tensor(cots[name])).sum().backward()
        for i, leaf in enumerate(leaves):
            _close(got[f"{name}.dx{i}"], scale * leaf.grad.numpy(), 1e-5, f"{name}.dx{i}")

    for sh in (-4, 4):
        want(f"roll{sh}", lambda t, sh=sh: roll_hw(t, sh, sh), x)
    w = tensor(w_conv)
    want("conv", lambda t: conv2d(t, w, padding=1), x)
    want("extend", lambda t: conv2d(t, w, padding=1), x)
    want("gather", lambda t: t, x, scale=4.0)
    want("cross", cross, ca["q"], ca["kv"])
    for k, p in cross.named_parameters():
        _close(got[f"cross.{k}"], p.grad.numpy(), 1e-5, f"cross.{k}")
    g = {k: tensor(v).requires_grad_() for k, v in sp.items() if k != "x"}
    sa.temperature.data = g["temp"]
    for name, key in (("qkv", "wqkv"), ("qkv_dwconv", "wdw"), ("project_out", "wout")):
        getattr(sa, name).weight = torch.nn.Parameter(g[key])
    ln = torch.nn.LayerNorm(8)
    ln.weight, ln.bias = torch.nn.Parameter(g["ln_w"]), torch.nn.Parameter(g["ln_b"])
    want("spectral", lambda t: apply_(t, sa.comb(t, ln=ln), sa.qkv.weight, sa.qkv_dwconv.weight,
                                      ln_w=ln.weight, ln_b=ln.bias, residual=True), sp["x"])
    grads = dict(wqkv=sa.qkv.weight.grad, wdw=sa.qkv_dwconv.weight.grad,
                 temp=sa.temperature.grad, wout=sa.project_out.weight.grad, ln_w=ln.weight.grad,
                 ln_b=ln.bias.grad)
    for k, v in grads.items():
        _close(got[f"spectral.{k}"], v.numpy(), 1e-5, f"spectral.{k}")


def _flat(params):
    from flax import traverse_util

    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def test_sharded_pgsstb_grads_match_jax_sharded_vjp():
    """The PGSSTB training route on 2 gloo ranks (8 rows each of a batch of
    2 x 16 x 32 x 16, tests/test_pallas_vjp.py:330's shape), unshifted and
    shifted, drop-path active (JAX's two draws from one key, the same on
    both shards): the parameter gradients summed over the ranks and the
    gathered input gradient == JAX's sharded VJP (shard_map over a 1 x 2
    mesh, its jnp route with ppermute halos and psum'd statistics), 1e-4
    of each tensor's largest magnitude."""
    from flax import linen as fnn
    from jax.sharding import PartitionSpec as P

    from mp_hsir_tpu.models.layers import PGSSTB as JaxPGSSTB, DropPath as JaxDropPath
    from mp_hsir_tpu.parallel.mesh import SPATIAL_AXIS as JAX_SPATIAL
    from mp_hsir_tpu.parallel.mesh import make_mesh as jax_mesh
    from mp_hsir_tpu_torch.checkpoint import params_from_jax
    from mp_hsir_tpu_torch.models.layers import PGSSTB
    from torch_mesh_ranks import pgsstb_grads_rank

    if len(jax.devices()) < 2:
        pytest.skip("JAX's sharded VJP needs 2 devices")
    dim, heads, b = 16, 2, 2
    r = rng(42)
    x = normal(r, (b, 16, 32, dim), 0.5)
    cot = normal(r, (b, 16, 32, dim))
    key = jax.random.key(3)

    class Probe(fnn.Module):  # JaxPGSSTB's drop_path scope: the same two draws
        @fnn.compact
        def __call__(self, ones):
            dpm = JaxDropPath(0.3, name="drop_path")
            return dpm(ones, False).reshape(b), dpm(ones, False).reshape(b)

    dps = [np.asarray(d) for d in Probe().apply({}, jnp.ones((b, 1, 1, 1)),
                                                rngs={"droppath": key})]
    mesh = jax_mesh(1, 2)
    bspec = P(None, JAX_SPATIAL, None, None)
    kws = [dict(dim=dim, num_heads=heads, window_size=8, shift_size=shift, mlp_ratio=2.0,
                compress_ratio=4, prompt_len=8, input_resolution=(64, 64), drop_path=0.3)
           for shift in (0, 4)]
    inits = [JaxPGSSTB(**kw).init(jax.random.key(kw["shift_size"]), jnp.asarray(x), True)["params"]
             for kw in kws]
    blocks = []
    for kw, params in zip(kws, inits):
        port = PGSSTB(dim, heads, 8, kw["shift_size"], 2.0, 4, 8, (64, 64), drop_path=0.3)
        state = params_from_jax(_flat(params), port.state_dict())
        blocks.append((kw, {k: v.numpy() for k, v in state.items()}))
    pending = _spawn_async(pgsstb_grads_rank, 2, blocks, x, cot, dps)
    wants = []
    for kw, params in zip(kws, inits):
        sharded = JaxPGSSTB(**kw, axis_name=JAX_SPATIAL)

        def local(p, xx, cc, sharded=sharded):
            def loss(pp, xl):
                y = sharded.apply({"params": pp}, xl, False, rngs={"droppath": key})
                return jnp.sum(y * cc)

            gp, gx = jax.grad(loss, argnums=(0, 1))(p, xx)
            return jax.lax.psum(gp, JAX_SPATIAL), gx

        gp, gx = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P(), bspec, bspec),
                                       out_specs=(P(), bspec), check_vma=False))(
            params, jnp.asarray(x), jnp.asarray(cot))
        port = PGSSTB(dim, heads, 8, kw["shift_size"], 2.0, 4, 8, (64, 64), drop_path=0.3)
        wants.append((params_from_jax(_flat(gp), port.state_dict()), np.asarray(gx)))
    got = pending.result()
    for shift, (g_params, g_x), (w_params, w_x) in zip((0, 4), got, wants):
        assert set(g_params) == set(w_params)
        for k, w in w_params.items():
            _close(g_params[k], w.numpy(), 1e-4, f"shift {shift}: {k}")
        _close(g_x, w_x, 1e-4, f"shift {shift}: dx")


def _train_setup(tiny, patch=64, jax_state=True):
    """Seeded port parameters (the TVSP text-query LayerNorm biases drawn at
    random, as tests/test_torch_train.py draws them: at zero their gradients
    are float32 noise, which Adam turns into +-lr steps), the port's train
    config with a first update at the base rate and, with ``jax_state``,
    JAX's train state on the same parameters."""
    from flax import traverse_util

    from mp_hsir_tpu.config import TrainConfig as JaxTrainConfig
    from mp_hsir_tpu.training.trainer import TrainState, make_optimizer
    from mp_hsir_tpu_torch.checkpoint import params_to_jax
    from mp_hsir_tpu_torch.config import ModelConfig
    from mp_hsir_tpu_torch.models.mp_hsir import build_model

    cfg = ModelConfig(**tiny)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    r = rng(0)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith("cross_transformer.norm11.bias"):
                v.copy_(tensor(0.5 * r.standard_normal(tuple(v.shape))))
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    tc = dict(epochs=4, steps_per_epoch=1, warmup_frac=0.0, lr=1e-4, eta_min=1e-6,
              patch_size=patch, batch_size=2)
    js = None
    if jax_state:
        params = traverse_util.unflatten_dict(
            {k: jnp.asarray(v) for k, v in params_to_jax(model.state_dict()).items()}, sep="/")
        tx = make_optimizer(JaxTrainConfig(**tc))
        js = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                        tx=tx)
    return js, cfg, tc, state


def test_train_step_on_a_2x2_mesh_matches_jax_make_train_step():
    """One step of make_train_step on a 2 x 2 mesh of gloo ranks (batch 2 x
    5 bands x 64 x 64: a sample per data group, 32 rows per rank; drop-path
    off) == JAX make_train_step(mc, make_mesh(data=2, spatial=2)) on its
    jnp route: the loss within rtol 1e-5, every parameter within 1e-5, and
    the parameters bitwise equal on the four ranks."""
    from mp_hsir_tpu.parallel.mesh import make_mesh as jax_mesh
    from mp_hsir_tpu.training.trainer import make_train_step as jax_step
    from mp_hsir_tpu_torch.checkpoint import params_from_jax
    from test_torch_train import TINY, _batch
    from torch_mesh_ranks import train_step_rank

    if len(jax.devices()) < 4:
        pytest.skip("JAX's 2 x 2 step needs 4 devices")
    from mp_hsir_tpu.config import ModelConfig as JaxModelConfig

    js, cfg, tc, state = _train_setup(TINY)
    batch = _batch(11, TINY, (0, 3), hw=64)
    pending = _spawn_async(train_step_rank, 4, cfg, dict(tc, mesh=(2, 2)), state, [batch], [0])
    js, jloss = jax_step(JaxModelConfig(**TINY), jax_mesh(2, 2))(
        js, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
    got = pending.result()
    np.testing.assert_allclose(got["losses"][0], float(jloss), rtol=1e-5)
    assert got["same"]
    want = params_from_jax(_flat(js.params))
    for k, v in want.items():
        np.testing.assert_allclose(got["params"][k], v.numpy(), atol=1e-5, rtol=0, err_msg=k)


def test_train_step_on_1x2_with_drop_path_matches_one_rank():
    """With drop-path on (rate up to 0.1), one step on a 1 x 2 mesh (each
    rank 32 of the 64 rows; the data group's generator is the one-rank
    step's) == the one-rank port step on the whole batch: the loss within
    rtol 1e-5, the averaged gradients within 1e-4 of each tensor's largest
    magnitude, the parameters within 1e-5, the same bits on both ranks."""
    from mp_hsir_tpu_torch.config import TrainConfig
    from mp_hsir_tpu_torch.models.mp_hsir import build_model
    from mp_hsir_tpu_torch.training.trainer import create_train_state, train_step
    from test_torch_train import TINY, _batch
    from torch_mesh_ranks import train_step_rank

    tiny = dict(TINY, drop_path_max=0.1)
    _, cfg, tc, state = _train_setup(tiny, jax_state=False)
    batch = _batch(12, tiny, (0, 3), hw=64)
    pending = _spawn_async(train_step_rank, 2, cfg, dict(tc, mesh=(1, 2)), state, [batch], [5],
                           True)
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
    pred_loss = float(train_step(st, tb, torch.Generator().manual_seed(5)))
    got = pending.result()
    np.testing.assert_allclose(got["losses"][0], pred_loss, rtol=1e-5)
    assert got["same"]
    assert set(got["grads"]) == set(grads)
    for k, g in grads.items():
        _close(got["grads"][k], g.numpy(), 1e-4, k)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(got["params"][k], v.numpy(), atol=1e-5, rtol=0, err_msg=k)
