"""The PyTorch port's backward (plain versions on the CPU, float32) against
the JAX package's custom-VJP cores and blocks, on the same numpy-seeded
inputs and cotangents.

* Each kernel wrapper's gradients (plain forward + explicit plain backward,
  as the wrappers run them on CPU tensors) against ``jax.vjp`` of the Pallas
  custom-VJP core it replaces, run with ``interpret=True`` as
  tests/test_pallas_vjp.py runs them (ops/pallas_vjp.py).
* Whole-block gradients of PGSSTB (shifted and not, drop-path active with
  JAX's own per-sample scales) and TransformerBlock against the JAX blocks'
  jnp path, after the weights go through ``params_from_jax``.

Tolerance: every gradient within 1e-4 of its own max-abs. The Pallas kernels
use a polynomial GELU (1.5e-6 from erf), exp2 softmax without the
max-subtract and sum in other orders; float32 on both sides.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from mp_hsir_tpu.ops import pallas_attention as PA
from mp_hsir_tpu_torch.checkpoint import params_from_jax
from mp_hsir_tpu_torch.ops.kernels.conv3 import conv3
from mp_hsir_tpu_torch.ops.kernels.gdfn import gdfn
from mp_hsir_tpu_torch.ops.kernels.mlp import mlp
from mp_hsir_tpu_torch.ops.kernels.spectral import spectral_apply, spectral_fold, spectral_stats
from mp_hsir_tpu_torch.ops.kernels.window_attention import window_attention
from mp_hsir_tpu_torch.ops.window import shifted_region_map
from torch_port_inputs import (
    normal as _n, oihw as _oihw, rng as _rng, spectral_weights as _spectral_weights,
    tensor as _t, uniform as _u, window_inputs as _window_inputs,
)
import torch_threads  # noqa: E402,F401  (one compute thread per process)

TOL = 1e-4


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: max abs err {err:.3e} > {TOL} * {scale:.3e}"


def _jax_vjp(fn, args, cots):
    """Gradients of sum(out * cot) of a JAX function w.r.t. every argument."""
    out, pull = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    if isinstance(out, (tuple, list)):
        return pull(type(out)(jnp.asarray(c) for c in cots))
    return pull(jnp.asarray(cots[0]))


def _torch_grads(fn, args, cots):
    ts = [_t(a).requires_grad_(True) for a in args]
    out = fn(*ts)
    out = out if isinstance(out, tuple) else (out,)
    loss = sum((o.float() * _t(c)).sum() for o, c in zip(out, cots))
    return [g.numpy() for g in torch.autograd.grad(loss, ts)]


def _cots(r, shapes):
    return [_n(r, s) for s in shapes]


@pytest.mark.parametrize("dp", [False, True])
def test_mlp_grads_match_pallas_vjp(dp):
    """mlp_fused with residual (and the per-sample drop-path scale)."""
    r = _rng(10)
    b, h, w, c, hid = 2, 16, 16, 8, 12
    args = [_n(r, (b, h, w, c)), 1 + _n(r, (c,), 0.1), _n(r, (c,), 0.1),
            _n(r, (c, 2 * hid), 0.3), _n(r, (2 * hid,), 0.1), _n(r, (hid, c), 0.3),
            _n(r, (c,), 0.1)]
    if dp:
        args.append(np.array([1.25, 0.0], np.float32))
    cots = _cots(r, [(b, h, w, c)])

    def jfn(*a):
        return PA.fused_ln_gated_mlp_nhwc(*a[:7], residual=True,
                                          dp_scale=a[7] if dp else None, interpret=True)

    def tfn(x, lw, lb, w1, b1, w2, b2, *d):
        return mlp(x, lw, lb, w1.t(), b1, w2.t(), b2, residual=True, dp_scale=d[0] if d else None)

    want = _jax_vjp(jfn, args, cots)
    got = _torch_grads(tfn, args, cots)
    for i, (g, wv) in enumerate(zip(got, want)):
        _close(g, wv, f"arg {i}")


def test_gdfn_grads_match_pallas_vjp():
    """gdfn_fused with residual (the TransformerBlock FFN)."""
    r = _rng(11)
    b, h, w, c, hid = 1, 24, 16, 8, 12
    args = [_n(r, (b, h, w, c)), 1 + _n(r, (c,), 0.1), _n(r, (c,), 0.1),
            _n(r, (1, 1, c, 2 * hid), 0.3), _n(r, (3, 3, 1, 2 * hid), 0.3),
            _n(r, (1, 1, hid, c), 0.3)]
    cots = _cots(r, [(b, h, w, c)])
    want = _jax_vjp(lambda *a: PA.fused_ln_gdfn_nhwc(*a, residual=True, interpret=True),
                    args, cots)

    def tfn(x, lw, lb, wi, wd, wo):
        return gdfn(x, lw, lb, wi.permute(3, 2, 0, 1), wd.permute(3, 2, 0, 1),
                    wo.permute(3, 2, 0, 1), residual=True)

    got = _torch_grads(tfn, args, cots)
    for i, (g, wv) in enumerate(zip(got, want)):
        _close(g, wv, f"arg {i}")


@pytest.mark.parametrize("shifted", [False, True])
def test_window_grads_match_pallas_vjp(shifted):
    """window_fused on the training route: unshifted, and shifted with the
    explicit roll-in and the region mask (the port rolls in-kernel, so the
    JAX side rolls inside the differentiated function)."""
    c, heads, h, w = 16, 2, 16, 16
    d = _window_inputs(12, c, heads, h, w)
    x = np.concatenate([d["x"], _n(_rng(13), (1, h, w, c))])
    shift = 4 if shifted else 0
    region = jnp.asarray(shifted_region_map(h, w, 8, 4)) if shifted else None
    names = ("ln_w", "ln_b", "wqkv", "bqkv", "rel_bias", "wp", "bp")
    args = [x] + [d[k] for k in names]
    cots = _cots(_rng(14), [(2, h, w, c), (2, h // 8, w // 8, c)])

    def jfn(x, *p):
        xr = jnp.roll(x, (-shift, -shift), axis=(1, 2)) if shift else x
        return PA.fused_ln_window_attention_nhwc(xr, *p, region, heads, interpret=True)

    def tfn(x, lw, lb, wq, bq, rb, wp, bp):
        return window_attention(x, lw, lb, wq.t(), bq, rb, wp.t(), bp, heads, shift=shift)

    want = _jax_vjp(jfn, args, cots)
    got = _torch_grads(tfn, args, cots)
    for i, (g, wv) in enumerate(zip(got, want)):
        _close(g, wv, f"arg {i}")


def _spectral_args(seed, b, h, w, c, heads):
    r = _rng(seed)
    sw = _spectral_weights(r, c, heads)
    return r, [_n(r, (b, h, w, c)), sw["wqkv"], sw["wdw"], sw["temp"], sw["wout"]]


def _port_spectral(x, wqkv, wdw, temp, wout, heads, shift=0, **kw):
    """stats -> fold -> apply, the port's composition of K7a/K7b (or K2)."""
    wq, wd = wqkv.permute(3, 2, 0, 1), wdw.permute(3, 2, 0, 1)
    lnkw = {k: kw[k] for k in ("ln_w", "ln_b") if k in kw}
    comb = spectral_fold(*spectral_stats(x, wq, wd, heads, shift=shift, **lnkw), temp,
                         wout.permute(3, 2, 0, 1))
    return spectral_apply(x, comb, wq, wd, shift=shift, **kw)


@pytest.mark.parametrize("shifted", [False, True])
def test_split_spectral_grads_match_pallas_vjp(shifted):
    """fused_spectral_attention_split (sp0/sp1 cores) with the PGSSTB training
    epilogue: per-window gate, shortcut and per-sample drop-path scale. The
    shifted block reads its input through the roll-back (the JAX side rolls
    explicitly and passes the rolled gate map)."""
    b, h, w, c, heads = 2, 16, 16, 8, 2
    r, args = _spectral_args(15, b, h, w, c, heads)
    args += [_n(r, (b, h // 8, w // 8, c), 0.5), _n(r, (b, h, w, c)),
             np.array([1.25, 0.0], np.float32)]
    cots = _cots(r, [(b, h, w, c)])
    shift = 4 if shifted else 0

    def jfn(x, wqkv, wdw, temp, wout, gate, short, dp):
        if not shift:
            return PA.fused_spectral_attention_split(
                x, wqkv, wdw, temp, wout, heads, gate=gate, shortcut=short, dp_scale=dp,
                interpret=True)
        gmap = jnp.roll(jnp.repeat(jnp.repeat(gate, 8, axis=1), 8, axis=2), (4, 4), axis=(1, 2))
        return PA.fused_spectral_attention_split(
            jnp.roll(x, (4, 4), axis=(1, 2)), wqkv, wdw, temp, wout, heads, gate_map=gmap,
            shortcut=short, dp_scale=dp, interpret=True)

    def tfn(x, wqkv, wdw, temp, wout, gate, short, dp):
        return _port_spectral(x, wqkv, wdw, temp, wout, heads, shift=shift, gate=gate,
                              shortcut=short, dp_scale=dp)

    want = _jax_vjp(jfn, args, cots)
    got = _torch_grads(tfn, args, cots)
    for i, (g, wv) in enumerate(zip(got, want)):
        _close(g, wv, f"arg {i}")


def test_spectral_ln_residual_grads_match_pallas_vjp():
    """spectral_fused with ln and residual (the TransformerBlock MDTA, K12)."""
    b, h, w, c, heads = 1, 24, 16, 8, 2
    r, args = _spectral_args(16, b, h, w, c, heads)
    args += [1 + _n(r, (c,), 0.1), _n(r, (c,), 0.1)]
    cots = _cots(r, [(b, h, w, c)])

    def jfn(x, wqkv, wdw, temp, wout, lw, lb):
        return PA.fused_spectral_attention_nhwc(x, wqkv, wdw, temp, wout, heads, ln_w=lw,
                                                ln_b=lb, residual=True, interpret=True)

    def tfn(x, wqkv, wdw, temp, wout, lw, lb):
        return _port_spectral(x, wqkv, wdw, temp, wout, heads, ln_w=lw, ln_b=lb, residual=True)

    want = _jax_vjp(jfn, args, cots)
    got = _torch_grads(tfn, args, cots)
    for i, (g, wv) in enumerate(zip(got, want)):
        _close(g, wv, f"arg {i}")


@pytest.mark.parametrize("mode", ["plain", "res", "down", "up"])
def test_conv3_grads_match_pallas_vjp(mode):
    """conv3x3_fused in each writeback (K13 = K4 on the flipped weights)."""
    r = _rng(17)
    b, h, w, cin, cout = 2, 16, 16, 8, 16
    args = [_n(r, (b, h, w, cin)), _n(r, (3, 3, cin, cout), 0.3)]
    if mode == "res":
        args.append(_n(r, (b, h, w, cout)))
    fns = {"plain": PA.fused_conv3x3_nhwc, "res": PA.fused_conv3x3_res_nhwc,
           "down": PA.fused_conv3x3_down_nhwc, "up": PA.fused_conv3x3_up_nhwc}
    out_shape = {"plain": (b, h, w, cout), "res": (b, h, w, cout),
                 "down": (b, h // 2, w // 2, 4 * cout), "up": (b, 2 * h, 2 * w, cout // 4)}[mode]
    cots = _cots(r, [out_shape])
    want = _jax_vjp(lambda *a: fns[mode](*a, interpret=True), args, cots)

    def tfn(x, wk, *res):
        return conv3(x, wk.permute(3, 2, 0, 1), mode, res[0] if res else None)

    got = _torch_grads(tfn, args, cots)
    for i, (g, wv) in enumerate(zip(got, want)):
        _close(g, wv, f"arg {i}")


# ---------------------------------------------------------------------------
# whole blocks
# ---------------------------------------------------------------------------

def _flat(params):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def _block_grads_close(port, jax_grads, x_grad_t, x_grad_j):
    grads = {k.replace(".", "/"): p.grad for k, p in port.named_parameters()}
    want = params_from_jax(_flat(jax_grads))
    assert set(want) == {k.replace("/", ".") for k in grads}
    for k, g in want.items():
        _close(grads[k.replace(".", "/")].numpy(), g.numpy(), k)
    _close(x_grad_t, x_grad_j, "dx")


@pytest.mark.parametrize("shifted", [False, True])
def test_pgsstb_block_grads_match_jax(shifted):
    """The PGSSTB training route (window -> PG gate -> stats -> fold -> apply
    with gate/shortcut/dp1 -> MLP with residual/dp2) against the JAX block,
    drop-path active: the per-sample scales are the ones JAX's DropPath draws
    from the same key (read by a probe module of the same scope path)."""
    from flax import linen as fnn

    from mp_hsir_tpu.models.layers import PGSSTB as JaxPGSSTB, DropPath as JaxDropPath
    from mp_hsir_tpu_torch.models.layers import PGSSTB

    dim, heads, b = 16, 2, 2
    kw = dict(dim=dim, num_heads=heads, window_size=8, shift_size=4 if shifted else 0,
              mlp_ratio=2.0, compress_ratio=4, prompt_len=8, input_resolution=(64, 64),
              drop_path=0.3)
    x = _n(_rng(18), (b, 16, 16, dim), 0.5)
    cot = _n(_rng(19), (b, 16, 16, dim))
    jb = JaxPGSSTB(**kw)
    params = jb.init(jax.random.key(0), jnp.asarray(x), True)["params"]
    key = jax.random.key(7)

    class Probe(fnn.Module):  # JaxPGSSTB's drop_path scope: the same two draws
        @fnn.compact
        def __call__(self, ones):
            dpm = JaxDropPath(0.3, name="drop_path")
            return dpm(ones, False).reshape(b), dpm(ones, False).reshape(b)

    dp1, dp2 = Probe().apply({}, jnp.ones((b, 1, 1, 1)), rngs={"droppath": key})

    def jloss(p, xx):
        y = jb.apply({"params": p}, xx, False, rngs={"droppath": key})
        return jnp.sum(y * cot)

    (gp, gx) = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))

    port = PGSSTB(dim, heads, 8, kw["shift_size"], 2.0, 4, 8, (64, 64), drop_path=0.3).train()
    port.load_state_dict(params_from_jax(_flat(params), port.state_dict()))
    xt = _t(x).requires_grad_(True)
    y = port(xt, (_t(np.asarray(dp1)), _t(np.asarray(dp2))))
    want_y = jb.apply({"params": params}, jnp.asarray(x), False, rngs={"droppath": key})
    _close(y.detach().numpy(), want_y, "forward")
    (y * _t(cot)).sum().backward()
    _block_grads_close(port, gp, xt.grad.numpy(), gx)


def test_transformer_block_grads_match_jax():
    """TransformerBlock (spectral ln+residual, GDFN residual) on the training
    route against the JAX block's jnp path."""
    from mp_hsir_tpu.models.layers import TransformerBlock as JaxTB
    from mp_hsir_tpu_torch.models.layers import TransformerBlock

    dim, heads = 16, 2
    x = _n(_rng(20), (2, 16, 16, dim), 0.5)
    cot = _n(_rng(21), (2, 16, 16, dim))
    jb = JaxTB(dim, heads)
    params = jb.init(jax.random.key(1), jnp.asarray(x))["params"]
    gp, gx = jax.grad(lambda p, xx: jnp.sum(jb.apply({"params": p}, xx) * cot),
                      argnums=(0, 1))(params, jnp.asarray(x))
    port = TransformerBlock(dim, heads).train()
    port.load_state_dict(params_from_jax(_flat(params), port.state_dict()))
    xt = _t(x).requires_grad_(True)
    (port(xt) * _t(cot)).sum().backward()
    _block_grads_close(port, gp, xt.grad.numpy(), gx)
