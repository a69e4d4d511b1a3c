"""The head-parallel spectral mesh axis of the PyTorch port
(``make_mesh(data, spatial, spectral)``, ``parallel/tp.py``) on the CPU:

* the plain versions of the spectral stats and apply launches on a
  member's head block (q/k/v width CL = C / 2 from the weight, comb (B, CL,
  C)) against the JAX package's ``_sp0_call`` / ``_sp1_call`` in interpret
  mode, members 0 and 1, with and without halo rows, with the gate, the
  per-pixel gate map and the drop-path scale, in float32 (1e-5) and bf16
  (BF16_TOL, the bound the bf16 halo versions are held to);
* their plain backwards against ``jax.vjp`` of ``sp0_sharded`` /
  ``sp1_sharded`` with CL < C, float32 (1e-5 of the largest magnitude) and
  bf16 (BF16_TOL, the activations rounded to bf16 on both sides);
* the members composed: their stats stacked and their applies (gate over
  n) summed against the whole attention's plain versions;
* over gloo ranks spawned on this machine (``tests/torch_mesh_ranks.py``):
  ``SpectralAttention``'s head-parallel route against JAX's
  ``test_spectral_tp_grads_match_unsharded`` set-up
  (``tests/test_model.py:130``) and the PGSSTB's TP epilogue, shifted and
  unshifted, against ``tests/test_pallas_vjp.py:494``'s (the loss within
  1e-5, the averaged gradients within 1e-4); the tiny model's eval step on
  a 1 x 2 x 2 mesh against JAX's ``make_eval_step`` on ``make_mesh(1, 2,
  2)`` (2e-5, ``tests/test_model.py:96``'s bar) and the port's one rank; a
  float32 train step on a 1 x 1 x 2 mesh against JAX's ``make_train_step``
  on ``make_mesh(1, 1, 2)`` (its averaged gradients captured by an optax
  transformation) and against the port's one rank; the same step in bf16
  (BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_TOL, tests/test_torch_mesh_bf16.py's
  STEP_JAX_GRAD_TOL) and the tiny bf16 model's eval step on 1 x 1 x 2
  against JAX's bf16 ``make_eval_step`` and the port's one rank (BF16_TOL).

The head-block kernels themselves are held to these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py phase 17)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_threads  # noqa: E402,F401  (one compute thread per process)
from mp_hsir_tpu.ops.pallas_attention import _sp0_call, _sp1_call
from mp_hsir_tpu.ops.pallas_vjp import sp0_sharded, sp1_sharded
from mp_hsir_tpu_torch.ops.kernels.spectral import (
    Halo, spectral_apply, spectral_apply_plain, spectral_stats, spectral_stats_plain,
)
from test_torch_mesh_train import _close, _spawn_async
from torch_port_inputs import normal, rng, tensor, uniform

TOL = 1e-5  # float32, of each output's largest magnitude
BF16_TOL = 3e-2  # bf16, as tests/test_torch_mesh_bf16.py holds the bf16 halo versions
GRAD_TOL = 1e-4  # the spawned runs' gradients (tests/test_model.py:130's bar)
STEP_JAX_GRAD_TOL = 1e-4  # the 1 x 1 x 2 step's gradients vs JAX, norm-wise
# the bf16 1 x 1 x 2 step: each member's partial projection rounds to bf16
# before the sum over the axis, one rank's whole projection once, so the
# mesh departs from one rank as JAX's bf16 mesh does: on seeds 15 and 16 the
# loss read 4.2e-5 / 7.3e-5 (relative) off JAX's and 3.3e-5 / 1.5e-5 off the
# one rank's, every parameter's gradient concatenated 2.27e-2 / 2.71e-2
# (norm-wise) off JAX's (within tests/test_torch_mesh_bf16.py's
# STEP_JAX_GRAD_TOL) and 1.70e-2 / 2.25e-2 off the one rank's: the loss
# within BF16_STEP_LOSS_RTOL, the gradients within BF16_STEP_GRAD_TOL of one
# rank's (about twice the readings)
BF16_STEP_LOSS_RTOL = 2e-4
BF16_STEP_GRAD_TOL = 5e-2
C, HEADS, N = 32, 4, 2  # the whole attention: C channels, 4 heads; 2 members
CL = C // N
HALOS = {"whole": (True, True), "interior": (False, False)}


def _member_cols(t, c=C, cl=CL):
    """Member t's q, k and v columns of a JAX (C, 3C) / (9, 3C) weight."""
    return np.concatenate([np.arange(s * c + t * cl, s * c + (t + 1) * cl) for s in range(3)])


def _inputs(seed):
    """A 16 x 16 map of C channels, its halo rows, the whole attention's
    weights (JAX layouts), a member-block comb (B, CL, C) for each member,
    the epilogue inputs and cotangents."""
    r = rng(seed)
    return dict(x=normal(r, (1, 16, 16, C)), top=normal(r, (1, 1, 16, C)),
                bot=normal(r, (1, 1, 16, C)), wqkv=uniform(r, (C, 3 * C), C),
                wdw=uniform(r, (9, 3 * C), 9), comb=normal(r, (N, 1, CL, C), CL ** -0.5),
                gate=normal(r, (1, 2, 2, C), 0.5), gmap=normal(r, (1, 16, 16, C), 0.5),
                dp=np.array([1.25], np.float32), dgram=normal(r, (1, CL, CL // (HEADS // N))),
                dnq=normal(r, (1, HEADS // N, CL // (HEADS // N))),
                dnk=normal(r, (1, HEADS // N, CL // (HEADS // N))),
                dy=normal(r, (1, 16, 16, C)))


def _rounded(a, dt):
    return a if dt == torch.float32 else tensor(a).to(dt).float().numpy()


def _member(d, t, dt):
    """Member t's operands: (x, halo rows, its weights in the port's layouts
    and JAX's, its comb), values rounded to dt."""
    cols = _member_cols(t)
    wq, wd = d["wqkv"][:, cols], d["wdw"][:, cols]
    port = (tensor(wq.T.reshape(3 * CL, C, 1, 1)), tensor(wd.T.reshape(3 * CL, 1, 3, 3)))
    return dict(x=_rounded(d["x"], dt), top=_rounded(d["top"], dt), bot=_rounded(d["bot"], dt),
                wq=wq, wd=wd, port=port, comb=d["comb"][t],
                gate=_rounded(d["gate"], dt) / N, gmap=_rounded(d["gmap"], dt) / N)


def _jx(a, dt):
    a = jnp.asarray(a)
    return a if dt == torch.float32 else a.astype(jnp.bfloat16)


def _near(got, want, dt, what=""):
    _close(np.asarray(got, np.float32), np.asarray(want, np.float32),
           TOL if dt == torch.float32 else BF16_TOL, what)


DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("halo", list(HALOS))
@pytest.mark.parametrize("member", [0, 1])
def test_head_block_stats_plain_matches_jax_sp0(member, halo, dtype):
    """spectral_stats_plain on member t's head block (wqkv (3CL, C), 2 of
    the 4 heads) == _sp0_call with the member's (C, 3CL) weight slice: the
    Gram (B, CL, dh) and both norms."""
    dt = DTYPES[dtype]
    m = _member(_inputs(41), member, dt)
    edges = HALOS[halo]
    x = tensor(m["x"]).to(dt)
    h = Halo(tensor(m["top"]).to(dt), tensor(m["bot"]).to(dt), *edges)
    got = spectral_stats_plain(x, m["port"][0].to(dt), m["port"][1].to(dt), HEADS // N, halo=h)
    want = _sp0_call(_jx(m["x"], dt), _jx(m["top"], dt), _jx(m["bot"], dt),
                     jnp.asarray(np.array(edges, np.int32)), jnp.asarray(m["wq"]),
                     jnp.asarray(m["wd"]), None, None, num_heads=HEADS // N, eps=1e-5,
                     interpret=True)
    assert tuple(got[0].shape) == (1, CL, CL // (HEADS // N))
    for g, w, name in zip(got, want, ("gram", "nq", "nk")):
        _near(g, w, dt, name)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", ["gate_dp", "gate_map"])
@pytest.mark.parametrize("member", [0, 1])
def test_head_block_apply_plain_matches_jax_sp1(member, variant, dtype):
    """spectral_apply_plain on member t's head block (v CL wide, comb (B,
    CL, C)) == _sp1_call with the member's weight slice: the partial
    projection with the gate over n and the drop-path scale (interior halo
    rows), and with the per-pixel gate map over n (the whole map)."""
    dt = DTYPES[dtype]
    m = _member(_inputs(42), member, dt)
    edges = HALOS["interior" if variant == "gate_dp" else "whole"]
    x = tensor(m["x"]).to(dt)
    h = Halo(tensor(m["top"]).to(dt), tensor(m["bot"]).to(dt), *edges)
    wq, wd = (w.to(dt) for w in m["port"])
    comb = tensor(m["comb"])
    jargs = (_jx(m["x"], dt), _jx(m["top"], dt), _jx(m["bot"], dt),
             jnp.asarray(np.array(edges, np.int32)), jnp.asarray(m["wq"]), jnp.asarray(m["wd"]),
             jnp.asarray(m["comb"]), None, None)
    kw = dict(num_heads=HEADS // N, eps=1e-5, residual=False, interpret=True)
    if variant == "gate_dp":
        got = spectral_apply_plain(x, comb, wq, wd, gate=tensor(m["gate"]).to(dt),
                                   dp_scale=tensor([1.25]), halo=h)
        want = _sp1_call(*jargs, _jx(m["gate"], dt), None, None, jnp.asarray([1.25]), **kw)
    else:
        got = spectral_apply_plain(x, comb, wq, wd, gate=tensor(m["gmap"]).to(dt), halo=h)
        want = _sp1_call(*jargs, None, _jx(m["gmap"], dt), None, None, **kw)
    assert got.dtype == dt and tuple(got.shape) == (1, 16, 16, C)
    _near(got.float(), np.asarray(want.astype(jnp.float32)), dt)


def test_head_blocks_compose_to_the_whole_attention():
    """The members' plain stats stacked == the whole attention's (every
    head's Gram and norms); the members' plain applies with the gate over n
    and the drop-path scale, summed == the whole apply with the gate, at
    comb the members' blocks stacked (B, C, C)."""
    d = _inputs(43)
    x = tensor(d["x"])
    h = Halo(tensor(d["top"]), tensor(d["bot"]), False, False)
    wq = tensor(d["wqkv"].T.reshape(3 * C, C, 1, 1))
    wd = tensor(d["wdw"].T.reshape(3 * C, 1, 3, 3))
    whole = spectral_stats_plain(x, wq, wd, HEADS, halo=h)
    parts = [spectral_stats_plain(x, *_member(d, t, torch.float32)["port"], HEADS // N, halo=h)
             for t in range(N)]
    for i, name in enumerate(("gram", "nq", "nk")):
        _near(torch.cat([p[i] for p in parts], dim=1), whole[i], torch.float32, name)
    comb = tensor(np.concatenate(list(d["comb"]), axis=1))
    dp, gate = tensor(d["dp"]), tensor(d["gate"])
    want = spectral_apply_plain(x, comb, wq, wd, gate=gate, dp_scale=dp, halo=h)
    got = sum(spectral_apply_plain(x, tensor(d["comb"][t]), *_member(d, t, torch.float32)["port"],
                                   gate=gate / N, dp_scale=dp, halo=h) for t in range(N))
    _near(got, want, torch.float32, "y")


def _leaf(a):
    return tensor(a).requires_grad_()


@functools.lru_cache(maxsize=None)
def _sp_vjps(heads):
    """jax.vjp of sp0_sharded and of sp1_sharded with the gate (or the gate
    map) and the drop-path scale, jitted: (edge, cotangents, inputs...)."""
    def sp0(edge, x, top, bot, wq, wd):
        return sp0_sharded(x, top, bot, edge, wq, wd, None, None, num_heads=heads, eps=1e-5,
                           interpret=True)

    def sp1(edge, x, top, bot, wq, wd, comb, gate, gmap, dp):
        return sp1_sharded(x, top, bot, edge, wq, wd, comb, None, None, gate, gmap, None, dp,
                           num_heads=heads, eps=1e-5, residual=False, interpret=True)

    def vjp(f):
        def run(edge, cots, *args):
            return jax.vjp(functools.partial(f, edge), *args)[1](cots)
        return jax.jit(run)

    def sp1_gate(edge, x, top, bot, wq, wd, comb, gate, dp):
        return sp1(edge, x, top, bot, wq, wd, comb, gate, None, dp)

    def sp1_gmap(edge, x, top, bot, wq, wd, comb, gmap, dp):
        return sp1(edge, x, top, bot, wq, wd, comb, None, gmap, dp)

    return vjp(sp0), vjp(sp1_gate), vjp(sp1_gmap)


def _check_halo(g, w, edge, name, dt=torch.float32):
    if edge:
        assert g is None or not g.abs().max(), name
    else:
        _near(g.float(), w, dt, name)


def _stats_bwd_case(dt):
    """K10a's plain backward on member 1's head block in ``dt`` against
    jax.vjp of sp0_sharded in ``dt`` (the activations rounded to it on both
    sides, the weights and cotangents float32)."""
    d = _inputs(44)
    m = _member(d, 1, dt)
    x, top, bot = (_leaf(m[k]).to(dt).detach().requires_grad_() for k in ("x", "top", "bot"))
    wq, wd = (w.clone().requires_grad_() for w in m["port"])
    out = spectral_stats(x, wq, wd, HEADS // N, halo=Halo(top, bot, False, False))
    torch.autograd.backward(out, [tensor(d[k]) for k in ("dgram", "dnq", "dnk")])
    edge = jnp.asarray(np.array([0, 0], np.int32))
    want = _sp_vjps(HEADS // N)[0](edge, tuple(jnp.asarray(d[k]) for k in ("dgram", "dnq", "dnk")),
                                   *[_jx(m[k], dt) for k in ("x", "top", "bot")],
                                   *[jnp.asarray(m[k]) for k in ("wq", "wd")])
    assert x.grad.dtype == dt
    _near(x.grad.float(), want[0], dt, "dx")
    _check_halo(top.grad, want[1], False, "dtop", dt)
    _check_halo(bot.grad, want[2], False, "dbot", dt)
    _near(wq.grad.reshape(3 * CL, C).T, want[3], dt, "dwqkv")
    _near(wd.grad.reshape(3 * CL, 9).T, want[4], dt, "dwdw")


def test_head_block_stats_backward_matches_jax_sp0_vjp():
    """K10a's plain backward on member 1's head block with interior halo
    rows (dx and the halo cotangents C wide; the q|k weight cotangents of
    the (3CL, C) slice, taps (3CL, 9)) == jax.vjp of sp0_sharded."""
    _stats_bwd_case(torch.float32)


def test_head_block_stats_backward_bf16_matches_jax_sp0_vjp():
    """The same in bf16 (the route of the bf16 head-block tiles K10a): every
    cotangent within BF16_TOL of jax.vjp of sp0_sharded in bf16."""
    _stats_bwd_case(torch.bfloat16)


def _apply_bwd_case(variant, dt):
    """K10b's plain backward on member 0's head block in ``dt`` against
    jax.vjp of sp1_sharded in ``dt`` (the activations and the gate rounded
    to it on both sides; the weights, comb, dp float32)."""
    d = _inputs(45)
    m = _member(d, 0, dt)
    x, top, bot = (_leaf(m[k]).to(dt).detach().requires_grad_() for k in ("x", "top", "bot"))
    comb = _leaf(m["comb"])
    wq, wd = (w.clone().requires_grad_() for w in m["port"])
    gk = "gate" if variant == "gate_dp" else "gmap"
    g = _leaf(m[gk]).to(dt).detach().requires_grad_()
    dp = _leaf(d["dp"])
    y = spectral_apply(x, comb, wq, wd, gate=g, dp_scale=dp, halo=Halo(top, bot, False, False))
    y.backward(tensor(d["dy"]).to(dt))
    edge = jnp.asarray(np.array([0, 0], np.int32))
    fn = _sp_vjps(HEADS // N)[1 if variant == "gate_dp" else 2]
    want = fn(edge, _jx(_rounded(d["dy"], dt), dt), *[_jx(m[k], dt) for k in ("x", "top", "bot")],
              *[jnp.asarray(m[k]) for k in ("wq", "wd", "comb")], _jx(m[gk], dt),
              jnp.asarray(d["dp"]))
    assert x.grad.dtype == dt
    _near(x.grad.float(), want[0], dt, "dx")
    _check_halo(top.grad, want[1], False, "dtop", dt)
    _check_halo(bot.grad, want[2], False, "dbot", dt)
    _near(wq.grad.reshape(3 * CL, C).T, want[3], dt, "dwqkv")
    _near(wd.grad.reshape(3 * CL, 9).T, want[4], dt, "dwdw")
    _near(comb.grad, want[5], dt, "dcomb")
    _near(g.grad.float(), want[6], dt, "dgate")
    _near(dp.grad, want[7], dt, "ddp")


@pytest.mark.parametrize("variant", ["gate_dp", "gate_map_dp"])
def test_head_block_apply_backward_matches_jax_sp1_vjp(variant):
    """K10b's plain backward on member 0's head block with the gate (or the
    gate map) over n and the drop-path scale, interior halo rows (dx, the
    halo cotangents, d gate, d dp C wide or per image; d comb (CL, C); the
    v weight cotangents of the slice) == jax.vjp of sp1_sharded."""
    _apply_bwd_case(variant, torch.float32)


@pytest.mark.parametrize("variant", ["gate_dp", "gate_map_dp"])
def test_head_block_apply_backward_bf16_matches_jax_sp1_vjp(variant):
    """The same in bf16 (the route of the bf16 head-block tiles K10b): every
    cotangent within BF16_TOL of jax.vjp of sp1_sharded in bf16."""
    _apply_bwd_case(variant, torch.bfloat16)


def test_heads_the_axis_does_not_divide_run_whole_on_every_member():
    """A PGSSTB of 3 heads on a spectral axis of 2 members runs its whole
    attention on the member (JAX's replicated route): the same output as
    without the axis, on the whole-map route, and no collective (so one
    process shows it)."""
    from mp_hsir_tpu_torch.models import layers
    from mp_hsir_tpu_torch.models.layers import PGSSTB
    from mp_hsir_tpu_torch.parallel.mesh import SPECTRAL_AXIS, Axis

    torch.manual_seed(0)
    blk = PGSSTB(24, 3, 8, 4, 2.0, 4, 8, (64, 64)).eval()
    x = tensor(rng(47).standard_normal((1, 16, 16, 24)))
    member = Axis(SPECTRAL_AXIS, 1, 2, None, False)
    layers.reset_path_stats()
    with torch.inference_mode():
        got, want = blk(x, None, None, member), blk(x)
    assert layers.PATH_STATS == {"pgsstb_kernels": 2}, layers.PATH_STATS
    assert torch.equal(got, want)


# --- spawned gloo ranks ------------------------------------------------------

def _flat(params):
    from flax import traverse_util

    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def test_spectral_attention_and_pgsstb_tp_grads_match_jax_unsharded():
    """Over 2 gloo ranks (a 1 x 1 x 2 mesh): SpectralAttention's
    head-parallel route on tests/test_model.py:130's set-up (dim 16, 4
    heads, x (1, 8, 8, 16), loss sum(y^2)), and the PGSSTB's TP epilogue on
    tests/test_pallas_vjp.py:494's (dim 16, 2 heads, x (2, 16, 32, 16)),
    unshifted and shifted, on the training route: the loss within 1e-5 of
    JAX's unsharded loss, every gradient (averaged over the ranks, as the
    trainer does) within GRAD_TOL of JAX's unsharded gradient, and every
    rank's output the same."""
    from mp_hsir_tpu.models.layers import PGSSTB as JaxPGSSTB
    from mp_hsir_tpu.models.layers import SpectralAttention as JaxSA
    from mp_hsir_tpu_torch.checkpoint import params_from_jax
    from mp_hsir_tpu_torch.models.layers import PGSSTB, SpectralAttention
    from torch_mesh_ranks import tp_grads_rank

    dim, heads = 16, 4
    xs = np.asarray(jax.random.uniform(jax.random.key(6), (1, 8, 8, dim)))
    jsa = JaxSA(dim, heads)
    sa_params = jsa.init(jax.random.key(7), jnp.asarray(xs))["params"]
    sa_state = params_from_jax(_flat(sa_params), SpectralAttention(dim, heads).state_dict())
    x = (rng(46).standard_normal((2, 16, 32, dim)) * 0.5).astype(np.float32)
    kws = [dict(dim=dim, num_heads=2, window_size=8, shift_size=shift, mlp_ratio=2.0,
                compress_ratio=4, prompt_len=8, input_resolution=(64, 64)) for shift in (0, 4)]
    inits = [JaxPGSSTB(**kw).init(jax.random.key(kw["shift_size"]), jnp.asarray(x), True)["params"]
             for kw in kws]
    blocks = []
    for kw, params in zip(kws, inits):
        port = PGSSTB(dim, 2, 8, kw["shift_size"], 2.0, 4, 8, (64, 64))
        state = params_from_jax(_flat(params), port.state_dict())
        blocks.append((kw, {k: v.numpy() for k, v in state.items()}))
    sa = dict(args=(dim, heads), state={k: v.numpy() for k, v in sa_state.items()}, x=xs)
    pending = _spawn_async(tp_grads_rank, 2, sa, blocks, x)

    wants = []
    loss, g = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(jnp.square(jsa.apply({"params": p}, jnp.asarray(xs))))))(sa_params)
    wants.append((float(loss), params_from_jax(_flat(g), SpectralAttention(dim, heads).state_dict())
                   , None))
    for kw, params in zip(kws, inits):
        blk = JaxPGSSTB(**kw)

        def loss_fn(p, xx, blk=blk):
            return jnp.sum(jnp.square(blk.apply({"params": p}, xx, False).astype(jnp.float32)))

        loss, (gp, gx) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(params,
                                                                            jnp.asarray(x))
        port = PGSSTB(dim, 2, 8, kw["shift_size"], 2.0, 4, 8, (64, 64))
        wants.append((float(loss), params_from_jax(_flat(gp), port.state_dict()), np.asarray(gx)))
    got = pending.result()
    assert got["same"]
    assert got["paths"] == {"pgsstb_kernels_tp": 2}, got["paths"]
    for what, (g_loss, g_grads), (w_loss, w_grads, w_x) in zip(
            ("attention", "pgsstb", "pgsstb shifted"), got["results"], wants):
        np.testing.assert_allclose(g_loss, w_loss, rtol=1e-5, err_msg=what)
        for k, w in w_grads.items():
            _close(g_grads[k], w.numpy(), GRAD_TOL, f"{what}: {k}")
        if w_x is not None:
            _close(g_grads["x"], w_x, GRAD_TOL, f"{what}: dx")


def test_tiny_model_on_1x2x2_matches_jax_make_eval_step():
    """The tiny 100-band model's eval step (make_eval_step on a 1 x 2 x 2
    mesh of 4 gloo ranks, 32 rows and half of every spectral attention's
    heads a rank) against JAX's make_eval_step(TINY_RS, make_mesh(1, 2, 2))
    on the same weights (2e-5, tests/test_model.py:96's bar) and against the
    port's one-rank forward (2e-5)."""
    from mp_hsir_tpu.config import ModelConfig as JaxModelConfig
    from mp_hsir_tpu.models.mp_hsir import init_params
    from mp_hsir_tpu.parallel.mesh import make_mesh as jax_mesh
    from mp_hsir_tpu.training.trainer import make_eval_step as jax_step
    from mp_hsir_tpu_torch.checkpoint import params_from_jax
    from mp_hsir_tpu_torch.config import ModelConfig
    from mp_hsir_tpu_torch.models.mp_hsir import build_model
    from test_torch_train import TINY_RS
    from torch_mesh_ranks import model_rank

    if len(jax.devices()) < 4:
        pytest.skip("JAX's 1 x 2 x 2 step needs 4 devices")
    tiny = {k: v for k, v in TINY_RS.items() if k != "drop_path_max"}
    jc = JaxModelConfig(**tiny)
    params = init_params(jc, jax.random.key(0), sample_hw=64)
    x = rng(7).random((1, 100, 64, 64)).astype(np.float32)
    cfg = ModelConfig(**tiny)
    model = build_model(cfg, device="cpu")
    state = params_from_jax(_flat(params), model.state_dict())
    pending = _spawn_async(model_rank, 4, cfg, {k: v.numpy() for k, v in state.items()}, x, [6],
                           (1, 2, 2))
    want_jax = np.asarray(jax_step(jc, jax_mesh(1, 2, 2))(params, jnp.asarray(x),
                                                          jnp.asarray([6], jnp.int32)))
    model.load_state_dict(state)
    with torch.inference_mode():
        want = model(torch.from_numpy(x), torch.tensor([6])).numpy()
    got = pending.result()
    np.testing.assert_allclose(got, want_jax, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def _step_1x1x2(tiny, seed):
    """One step of make_train_step on a 1 x 1 x 2 mesh of gloo ranks (batch
    2 x 5 bands x 64 x 64, every spectral attention head-parallel; drop-path
    off) in ``tiny``'s compute type, JAX make_train_step(mc, make_mesh(1, 1,
    2)) on the same parameters and batch (its averaged gradients captured by
    an optax transformation) and the port's one rank: (the ranks' result,
    JAX's loss and gradients, the one rank's loss and gradients)."""
    from flax import traverse_util

    from mp_hsir_tpu.config import ModelConfig as JaxModelConfig
    from mp_hsir_tpu.parallel.mesh import make_mesh as jax_mesh
    from mp_hsir_tpu.training.trainer import make_train_step as jax_step
    from mp_hsir_tpu_torch.checkpoint import params_from_jax
    from mp_hsir_tpu_torch.config import TrainConfig
    from mp_hsir_tpu_torch.models.mp_hsir import build_model
    from mp_hsir_tpu_torch.training.trainer import create_train_state, train_step
    from test_torch_mesh_bf16 import _grad_capture
    from test_torch_mesh_train import _train_setup
    from test_torch_train import _batch
    from torch_mesh_ranks import train_step_rank

    if len(jax.devices()) < 2:
        pytest.skip("JAX's 1 x 1 x 2 step needs 2 devices")
    js, cfg, tc, state = _train_setup(tiny)
    batch = _batch(seed, tiny, (0, 3), hw=64)
    pending = _spawn_async(train_step_rank, 2, cfg, dict(tc, mesh=(1, 1, 2)), state, [batch],
                           [0], True)
    cap = _grad_capture()
    js = js.replace(tx=cap, opt_state=cap.init(js.params))
    js, jloss = jax_step(JaxModelConfig(**tiny), jax_mesh(1, 1, 2))(
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
    return got, float(jloss), jgrads, one_loss, grads


def test_train_step_on_1x1x2_matches_jax_and_one_rank():
    """One float32 step of make_train_step on a 1 x 1 x 2 mesh of gloo ranks
    (batch 2 x 5 bands x 64 x 64, every spectral attention head-parallel;
    drop-path off): the loss within rtol 1e-5 of JAX make_train_step(mc,
    make_mesh(1, 1, 2)) and of the port's one rank; the averaged gradients,
    every parameter's concatenated, within STEP_JAX_GRAD_TOL (norm-wise) of
    JAX's, and each parameter's within GRAD_TOL of its largest magnitude in
    the port's one-rank step; the parameters bitwise equal on both ranks."""
    from test_torch_train import TINY

    got, jloss, jgrads, one_loss, grads = _step_1x1x2(TINY, 14)
    np.testing.assert_allclose(got["losses"][0], jloss, rtol=1e-5)
    np.testing.assert_allclose(got["losses"][0], one_loss, rtol=1e-5)
    keys = sorted(grads)
    mesh = np.concatenate([got["grads"][k].ravel() for k in keys])
    jax_flat = np.concatenate([jgrads[k].numpy().ravel() for k in keys])
    err_jax = np.linalg.norm(mesh - jax_flat) / np.linalg.norm(jax_flat)
    assert err_jax <= STEP_JAX_GRAD_TOL, err_jax
    for k, g in grads.items():
        _close(got["grads"][k], g.numpy(), GRAD_TOL, k)


def test_train_step_bf16_on_1x1x2_matches_jax_and_one_rank():
    """The same step in bf16 (the route of the four bf16 head-block tiles on
    the card; the plain bf16 versions here): the loss within
    BF16_STEP_LOSS_RTOL of JAX's bf16 1 x 1 x 2 step and of the port's
    one-rank bf16 step; the averaged gradients, every parameter's
    concatenated, within tests/test_torch_mesh_bf16.py's STEP_JAX_GRAD_TOL of
    JAX's and BF16_STEP_GRAD_TOL of the one rank's (norm-wise); the
    parameters bitwise equal on both ranks."""
    from test_torch_mesh_bf16 import STEP_JAX_GRAD_TOL as BF16_JAX_GRAD_TOL
    from test_torch_train import TINY

    got, jloss, jgrads, one_loss, grads = _step_1x1x2(dict(TINY, compute_dtype="bfloat16"), 15)
    np.testing.assert_allclose(got["losses"][0], jloss, rtol=BF16_STEP_LOSS_RTOL)
    np.testing.assert_allclose(got["losses"][0], one_loss, rtol=BF16_STEP_LOSS_RTOL)
    keys = sorted(grads)
    mesh = np.concatenate([got["grads"][k].ravel() for k in keys])
    one = np.concatenate([grads[k].numpy().ravel() for k in keys])
    jax_flat = np.concatenate([jgrads[k].numpy().ravel() for k in keys])
    err_jax = np.linalg.norm(mesh - jax_flat) / np.linalg.norm(jax_flat)
    err = np.linalg.norm(mesh - one) / np.linalg.norm(one)
    assert err_jax <= BF16_JAX_GRAD_TOL, err_jax
    assert err <= BF16_STEP_GRAD_TOL, err


def test_tiny_bf16_model_on_1x1x2_matches_jax_make_eval_step():
    """The tiny model in bf16 (5 bands, 64 x 64, one of the two heads of
    every spectral attention a rank) through make_eval_step on a 1 x 1 x 2
    mesh of gloo ranks against JAX's bf16 make_eval_step on make_mesh(1, 1,
    2) and against the port's one-rank bf16 forward, on the same weights:
    max-abs within BF16_TOL of the output's largest magnitude."""
    from mp_hsir_tpu.config import ModelConfig as JaxModelConfig
    from mp_hsir_tpu.models.mp_hsir import init_params
    from mp_hsir_tpu.parallel.mesh import make_mesh as jax_mesh
    from mp_hsir_tpu.training.trainer import make_eval_step as jax_step
    from mp_hsir_tpu_torch.checkpoint import params_from_jax
    from mp_hsir_tpu_torch.config import ModelConfig
    from mp_hsir_tpu_torch.models.mp_hsir import build_model
    from test_torch_train import TINY
    from torch_mesh_ranks import model_rank

    if len(jax.devices()) < 2:
        pytest.skip("JAX's 1 x 1 x 2 step needs 2 devices")
    tiny = {k: v for k, v in TINY.items() if k != "drop_path_max"}
    tiny["compute_dtype"] = "bfloat16"
    jc = JaxModelConfig(**tiny)
    params = init_params(jc, jax.random.key(1), sample_hw=64)
    x = rng(8).random((1, 5, 64, 64)).astype(np.float32)
    cfg = ModelConfig(**tiny)
    model = build_model(cfg, device="cpu")
    state = params_from_jax(_flat(params), model.state_dict())
    pending = _spawn_async(model_rank, 2, cfg, {k: v.numpy() for k, v in state.items()}, x, [3],
                           (1, 1, 2))
    want_jax = np.asarray(jax_step(jc, jax_mesh(1, 1, 2))(params, jnp.asarray(x),
                                                          jnp.asarray([3], jnp.int32)),
                          np.float32)
    model.load_state_dict(state)
    with torch.inference_mode():
        want = model(torch.from_numpy(x), torch.tensor([3])).float().numpy()
    got = np.asarray(pending.result(), np.float32)
    _close(got, want_jax, BF16_TOL, "vs JAX")
    _close(got, want, BF16_TOL, "vs one rank")
