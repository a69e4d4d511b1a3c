"""Each CUDA kernel of the PyTorch port against its plain version, on the
card (skipped without one). Run there with
``python -m pytest --noconftest tests/test_torch_cuda.py`` (the repository's
conftest configures JAX, which the card's machine does not need).

Tolerance: float32 on both sides, same rounding points, sums in other
orders: 1e-4 absolute and relative (1e-3 for the Gram sums over all pixels).
"""

import numpy as np
import pytest
import torch

from mp_hsir_tpu_torch.ops.kernels import _route
from mp_hsir_tpu_torch.ops.kernels.conv3 import conv3
from mp_hsir_tpu_torch.ops.kernels.gdfn import gdfn
from mp_hsir_tpu_torch.ops.kernels.spectral import (
    spectral_apply, spectral_fold, spectral_stats, spectral_stats_plain,
)
from mp_hsir_tpu_torch.ops.kernels.window_attention import window_attention
from torch_port_inputs import (
    normal as _n, oihw as _oihw, rng as _rng, spectral_weights as _spectral_weights,
    tensor as _t, uniform as _u, window_inputs as _window_inputs,
)


@pytest.fixture(autouse=True)
def _full_float32():
    """The plain reference in full float32: cuDNN convolutions default to
    TF32 on the card, which keeps about three decimal digits."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _pair(fn, *args, **kw):
    """(kernel result, plain-version result) of one wrapper on the same inputs."""
    out = fn(*args, **kw)
    with _route.plain_reference():
        ref = fn(*args, **kw)
    return out, ref


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 4])
def test_cuda_window_and_stats_match_plain(shift):
    dev = _cuda()
    c, heads = 64, 2
    d = _window_inputs(5, c, heads, 32, 32)
    args = [_t(d[k]).to(dev) for k in ("x", "ln_w", "ln_b")]
    args += [_t(d["wqkv"]).t().to(dev), _t(d["bqkv"]).to(dev), _t(d["rel_bias"]).to(dev),
             _t(d["wp"]).t().to(dev), _t(d["bp"]).to(dev)]
    got, ref = _pair(window_attention, *args, heads, shift=shift)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)
    wqkv = _t(d["wqkv_sp"]).t().reshape(3 * c, c, 1, 1).to(dev)
    wdw = _t(d["wdw_sp"]).t().reshape(3 * c, 1, 3, 3).to(dev)
    got, ref = _pair(spectral_stats, got[0], wqkv, wdw, heads, shift=shift)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-3, rtol=1e-4)


# (B, H, W, Cin, Cout): Cin 31 and 100 stage the halo by element (pixel rows
# not 16-byte aligned) and end in a partial 16-channel K chunk, 40 by 16-byte
# copies with a half chunk, 512 and 768 run 32 and 48 chunks; Cout 31, 48 and
# 100 mask the store inside a 64-channel tile (and take the element-wise
# store where the output row is not a whole number of 16-byte vectors);
# H or W = 8 and 24 leave half of the last 16x16 tile outside the map.
CONV3_SHAPES = [(1, 8, 8, 31, 64), (2, 16, 24, 31, 31), (1, 8, 24, 100, 48),
                (1, 16, 8, 100, 100), (1, 8, 24, 512, 512), (2, 8, 8, 512, 31),
                (1, 24, 16, 40, 100), (1, 8, 8, 768, 48)]
CONV3_CASES = [(mode,) + s for mode in ("plain", "res", "down", "up") for s in CONV3_SHAPES
               if mode != "up" or s[4] % 4 == 0]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,b,h,w,cin,cout", CONV3_CASES)
def test_cuda_conv3_matches_plain(mode, b, h, w, cin, cout):
    """bf16 within 3e-2 and float32 within 1e-4 of the plain version's
    max-abs (the chip_smoke.py tolerances: the same rounding points, float32
    sums in another order)."""
    dev = _cuda()
    rng = _rng(6)
    x = _t(_n(rng, (b, h, w, cin))).to(dev)
    wt = _t(_u(rng, (cout, cin, 3, 3), 9 * cin)).to(dev)
    res = _t(_n(rng, (b, h, w, cout))).to(dev) if mode == "res" else None
    for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
        got, ref = _pair(conv3, x.to(dt), wt, mode, res)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        scale = ref.float().abs().max().item()
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= tol * scale, f"{dt}: max abs err {err:.3e} > {tol} * {scale:.3e}"


@pytest.mark.cuda
def test_cuda_apply_and_gdfn_match_plain():
    dev = _cuda()
    c, heads, hid = 64, 2, 170
    rng = _rng(7)
    sw = _spectral_weights(rng, c, heads)
    x, short = _t(_n(rng, (1, 32, 32, c))).to(dev), _t(_n(rng, (1, 32, 32, c))).to(dev)
    gate = _t(_n(rng, (1, 4, 4, c), 0.5)).to(dev)
    wqkv, wdw = _oihw(sw["wqkv"]).to(dev), _oihw(sw["wdw"]).to(dev)
    comb = spectral_fold(*spectral_stats_plain(x, wqkv, wdw, heads, shift=4),
                         _t(sw["temp"]).to(dev), _oihw(sw["wout"]).to(dev))
    mlp = (torch.ones(c, device=dev), torch.zeros(c, device=dev),
           _t(_u(rng, (2 * hid, c), c)).to(dev), _t(_u(rng, (2 * hid,), c)).to(dev),
           _t(_u(rng, (c, hid), hid)).to(dev), _t(_u(rng, (c,), hid)).to(dev))
    got, ref = _pair(spectral_apply, x, comb, wqkv, wdw, shift=4, gate=gate,
                     shortcut=short, mlp=mlp)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    w_in = _t(_u(rng, (2 * hid, c, 1, 1), c)).to(dev)
    w_dw = _t(_u(rng, (2 * hid, 1, 3, 3), 9)).to(dev)
    w_out = _t(_u(rng, (c, hid, 1, 1), hid)).to(dev)
    proj = _t(_u(rng, (32, c, 1, 1), c)).to(dev)
    got, ref = _pair(gdfn, x, mlp[0], mlp[1], w_in, w_dw, w_out, residual=True, proj_w=proj)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 4])
def test_cuda_window_stats_batch2_nonsquare(shift):
    """Batch 2 and a 16x48 map (odd window-column count): per-image grid and
    per-image partial sums of the stats launch."""
    dev = _cuda()
    c, heads = 32, 2
    d = _window_inputs(8, c, heads, 16, 48)
    x = _t(np.concatenate([d["x"], -d["x"][:, ::-1]], axis=0)).to(dev)
    args = [x, _t(d["ln_w"]).to(dev), _t(d["ln_b"]).to(dev), _t(d["wqkv"]).t().to(dev),
            _t(d["bqkv"]).to(dev), _t(d["rel_bias"]).to(dev), _t(d["wp"]).t().to(dev),
            _t(d["bp"]).to(dev)]
    got, ref = _pair(window_attention, *args, heads, shift=shift)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)
    wqkv = _t(d["wqkv_sp"]).t().reshape(3 * c, c, 1, 1).to(dev)
    wdw = _t(d["wdw_sp"]).t().reshape(3 * c, 1, 3, 3).to(dev)
    got, ref = _pair(spectral_stats, got[0], wqkv, wdw, heads, shift=shift)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_tiny_model_matches_cpu_plain():
    """The whole tiny model (dim 16, 32x32, batch 2: its deepest maps are one
    8x8 shifted window) through the kernels on the card, float32, against
    the same weights through the plain versions on the CPU."""
    from mp_hsir_tpu_torch.config import ModelConfig
    from mp_hsir_tpu_torch.models.mp_hsir import build_model

    dev = _cuda()
    cfg = ModelConfig(in_channels=5, out_channels=5, dim=16, num_blocks=(1, 1, 1),
                      num_refinement_blocks=1, heads=(2, 2, 2))
    torch.manual_seed(0)
    cpu = build_model(cfg, device="cpu")
    card = build_model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(_rng(9).random((2, 5, 32, 32)).astype(np.float32))
    tid = torch.tensor([0, 4])
    _route.reset_counters()
    with torch.no_grad():
        want = cpu(x, tid)
        got = card(x.to(dev), tid.to(dev)).cpu()
    assert _route.COUNTERS["window_attention"].launches == 6
    assert _route.ROUTE.plain_cuda_calls == 0
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_tiny_model_bf16_matches_plain_on_card():
    """The tiny model in bf16 (tensor-core products; dh 8, hidden 42 and
    16-wide maps leave every product ragged) against the plain versions on
    the card in bf16: both round at the same points, so they agree to a few
    bf16 ulps of the output's scale (3e-2 of its max, as chip_smoke.py)."""
    from mp_hsir_tpu_torch.config import ModelConfig
    from mp_hsir_tpu_torch.models.mp_hsir import build_model

    dev = _cuda()
    cfg = ModelConfig(in_channels=5, out_channels=5, dim=16, num_blocks=(1, 1, 1),
                      num_refinement_blocks=1, heads=(2, 2, 2), compute_dtype="bfloat16")
    torch.manual_seed(1)
    model = build_model(cfg, device=dev)
    x = torch.from_numpy(_rng(10).random((2, 5, 32, 32)).astype(np.float32)).to(dev)
    tid = torch.tensor([1, 2], device=dev)
    with torch.no_grad():
        got = model(x, tid)
        with _route.plain_reference():
            ref = model(x, tid)
    err = (got - ref).abs().max().item()
    assert torch.isfinite(got).all()
    assert err <= 3e-2 * ref.abs().max().item(), err


# ---------------------------------------------------------------------------
# training route: every wrapper's forward and backward kernels against the
# plain forward and explicit plain backward, same inputs and cotangents
# ---------------------------------------------------------------------------

def _vjp(fn, tensors, kw, cots=None):
    ts = [t.detach().clone().requires_grad_(True) for t in tensors]
    outs = fn(*ts, **kw)
    outs = outs if isinstance(outs, tuple) else (outs,)
    if cots is None:
        g = torch.Generator(device=outs[0].device).manual_seed(0)
        cots = [torch.randn(o.shape, generator=g, device=o.device).to(o.dtype) for o in outs]
    loss = sum((o.float() * c.float()).sum() for o, c in zip(outs, cots))
    return list(outs) + list(torch.autograd.grad(loss, ts)), cots


def _check_vjp(fn, tensors, kw, tol):
    got, cots = _vjp(fn, tensors, kw)
    with _route.plain_reference():
        ref, _ = _vjp(fn, tensors, kw, cots)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and a.dtype == b.dtype, (i, a.shape, b.shape)
        assert torch.isfinite(a.float()).all(), i
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        assert err <= tol * scale, f"output/grad {i}: {err:.3e} > {tol} * {scale:.3e}"


# (batch, map side, C, hidden, heads): a tiny and a flagship width; the
# remote-sensing latent (C = 384, 8 heads: the backward kernels' chunked
# plans) and its dec1 / refinement width (C = 192, 2 heads, dh 96: the
# window backward's resident plan, 1.3 KB under the limit)
TRAIN_WIDTHS = ((2, 16, 16, 42, 2), (2, 16, 256, 680, 8))
RS_TRAIN_WIDTHS = ((2, 16, 384, 1021, 8), (2, 16, 192, 510, 2))


def _train_cases(dev, dt, widths=TRAIN_WIDTHS, conv=True):
    """(name, fn, tensors, kwargs) at each width of ``widths``, and conv3's
    modes with ``conv``."""
    from mp_hsir_tpu_torch.ops.kernels.mlp import mlp

    r = _rng(30)
    f = lambda *s, scale=1.0: _t(_n(r, s, scale)).to(dev)  # noqa: E731
    act = lambda *s: f(*s).to(dt)  # noqa: E731
    cases = []
    for b, hw, c, hid, heads in widths:
        dp = torch.tensor([1.25, 0.0], device=dev)
        cases.append(("mlp", lambda *a: mlp(*a[:7], residual=True, dp_scale=a[7]),
                      [act(b, hw, hw, c), 1 + f(c, scale=0.1), f(c, scale=0.1),
                       f(2 * hid, c, scale=c ** -0.5), f(2 * hid, scale=0.1),
                       f(c, hid, scale=hid ** -0.5), f(c, scale=0.1), dp], {}))
        for shift in (0, 4):
            cases.append((f"window{shift}", window_attention,
                          [act(b, hw, hw, c), 1 + f(c, scale=0.1), f(c, scale=0.1),
                           f(3 * c, c, scale=c ** -0.5), f(3 * c, scale=0.1),
                           f(heads, 64, 64, scale=0.02), f(c, c, scale=c ** -0.5), f(c, scale=0.1)],
                          dict(num_heads=heads, shift=shift)))
            wq, wd = f(3 * c, c, 1, 1, scale=c ** -0.5), f(3 * c, 1, 3, 3, scale=1 / 3)

            def pgsstb_spectral(x, wq, wd, temp, wout, gate, short, dp, shift=shift, heads=heads):
                comb = spectral_fold(*spectral_stats(x, wq, wd, heads, shift=shift), temp, wout)
                return spectral_apply(x, comb, wq, wd, shift=shift, gate=gate, shortcut=short,
                                      dp_scale=dp)

            cases.append((f"spectral{shift}", pgsstb_spectral,
                          [act(b, hw, hw, c), wq, wd, 1 + f(heads, 1, 1, scale=0.2),
                           f(c, c, 1, 1, scale=c ** -0.5), act(b, hw // 8, hw // 8, c),
                           act(b, hw, hw, c), dp], {}))

        def tb_spectral(x, wq, wd, temp, wout, lw, lb, heads=heads):
            comb = spectral_fold(*spectral_stats(x, wq, wd, heads, ln_w=lw, ln_b=lb), temp, wout)
            return spectral_apply(x, comb, wq, wd, ln_w=lw, ln_b=lb, residual=True)

        cases.append(("spectral_ln", tb_spectral,
                      [act(b, hw, hw, c), f(3 * c, c, 1, 1, scale=c ** -0.5),
                       f(3 * c, 1, 3, 3, scale=1 / 3), 1 + f(heads, 1, 1, scale=0.2),
                       f(c, c, 1, 1, scale=c ** -0.5), 1 + f(c, scale=0.1), f(c, scale=0.1)], {}))
        cases.append(("gdfn", gdfn, [act(b, hw, hw, c), 1 + f(c, scale=0.1), f(c, scale=0.1),
                                     f(2 * hid, c, 1, 1, scale=c ** -0.5),
                                     f(2 * hid, 1, 3, 3, scale=1 / 3),
                                     f(c, hid, 1, 1, scale=hid ** -0.5)], dict(residual=True)))
    if not conv:
        return cases
    for mode, cin, cout in (("plain", 31, 64), ("down", 64, 32), ("up", 256, 512), ("res", 128, 31)):
        ts = [act(2, 16, 16, cin), f(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)]
        kw = dict(mode=mode)
        if mode == "res":
            kw["res"] = f(2, 16, 16, cout)
        cases.append((f"conv3_{mode}", conv3, ts, kw))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_cuda_train_route_kernels_match_plain(dtype, tol):
    """Forward and backward kernels of every training-route wrapper at a tiny
    and a flagship width: float32 within 1e-4 and bf16 within 3e-2 of each
    output's and gradient's max-abs (as chip_smoke.py)."""
    dev = _cuda()
    faults = []
    for name, fn, ts, kw in _train_cases(dev, getattr(torch, dtype)):
        try:
            _check_vjp(fn, ts, kw, tol)
        except AssertionError as e:
            faults.append(f"{name} {tuple(ts[0].shape)}: {e}")
    assert not faults, "\n".join(faults)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_cuda_remote_sensing_backward_matches_plain(dtype, tol):
    """The backward kernels at the remote-sensing widths against the plain
    backward, through each wrapper's autograd: mlp with drop-path, window
    attention plain and shifted, the PGSSTB spectral pair (apply_bwd with
    gate, shortcut and drop-path), the TransformerBlock one (LN, residual)
    and gdfn; float32 within 1e-4 and bf16 within 3e-2 of each output's and
    gradient's max-abs (as chip_smoke.py). Every backward plan lies within
    the device's opt-in limit; at C = 384 they stream 64-channel chunks,
    and the window backward at C = 192 with 2 heads stays resident."""
    from mp_hsir_tpu_torch.ops.kernels import _build

    dev = _cuda()
    faults = []
    for name, fn, ts, kw in _train_cases(dev, getattr(torch, dtype), RS_TRAIN_WIDTHS, conv=False):
        try:
            _check_vjp(fn, ts, kw, tol)
        except AssertionError as e:
            faults.append(f"{name} {tuple(ts[0].shape)}: {e}")
    assert not faults, "\n".join(faults)
    for kernel, shape, want in (("window_attention_bwd", (384, 8), 64),
                                ("window_attention_bwd", (192, 2), 192),
                                ("mlp_bwd", (384,), 64), ("spectral_apply_bwd", (384,), 64),
                                ("gdfn_bwd", (384,), 64)):
        kc = _build.chunk(f"mp_{kernel}_chunk", *shape)
        assert kc == want, (kernel, shape, kc)
        assert 0 < _build.plan_bytes(f"mp_{kernel}_smem", *shape, kc) <= _build.smem_limit(), kernel
    assert 0 < _build.plan_bytes("mp_spectral_stats_bwd_smem", 384, 8) <= _build.smem_limit()
    assert 0 < _build.plan_bytes("mp_mlp_smem", 384, int(dtype == "bfloat16")) <= _build.smem_limit()


def _tiny_train(dev, seed=0):
    from mp_hsir_tpu_torch.config import ModelConfig
    from mp_hsir_tpu_torch.models.mp_hsir import build_model

    cfg = ModelConfig(in_channels=5, out_channels=5, dim=16, num_blocks=(1, 1, 1),
                      num_refinement_blocks=1, heads=(2, 2, 2), drop_path_max=0.0)
    torch.manual_seed(seed)
    return build_model(cfg, device=dev, train=True)


@pytest.mark.cuda
def test_cuda_tiny_train_step_matches_cpu_plain():
    """One train step of the tiny model on the card (float32 kernels, forward
    and backward) against the same step on the CPU plain path: the loss,
    every parameter gradient and the updated parameters."""
    from mp_hsir_tpu_torch.config import TrainConfig
    from mp_hsir_tpu_torch.training.trainer import create_train_state, train_step

    dev = _cuda()
    cpu = _tiny_train("cpu")
    card = _tiny_train(dev)
    card.load_state_dict(cpu.state_dict())
    tc = TrainConfig(epochs=4, steps_per_epoch=1, warmup_frac=0.25, lr=1e-4)
    r = _rng(31)
    clean = torch.from_numpy(r.random((2, 5, 32, 32)).astype(np.float32))
    batch = dict(degraded=(clean + 0.1 * torch.from_numpy(_n(r, (2, 5, 32, 32)))).clamp(0, 1),
                 clean=clean, task_id=torch.tensor([0, 3]))
    states = [create_train_state(m.cfg, tc, device=d, model=m) for m, d in ((cpu, "cpu"), (card, dev))]
    losses = []
    for st, d in zip(states, ("cpu", dev)):
        st.grad_accum = 2  # keep the gradients: no update on this first micro-step
        losses.append(train_step(st, {k: v.to(d) for k, v in batch.items()}).item())
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[0])
    for (k, p), q in zip(cpu.named_parameters(), card.parameters()):
        err = (q.grad.cpu() - p.grad).abs().max().item()
        assert err <= 1e-3 * p.grad.abs().max().item() + 1e-9, k
    for st in states:
        for group in st.optimizer.param_groups:
            group["lr"] = tc.lr
        st.optimizer.step()
    for (k, p), q in zip(cpu.named_parameters(), card.parameters()):
        torch.testing.assert_close(q.detach().cpu(), p.detach(), atol=2e-5, rtol=0, msg=k)


@pytest.mark.cuda
def test_cuda_forward_with_grad_reaches_every_parameter():
    """The fault the autograd Functions repair: a forward on the card with
    gradients enabled (training route) gives every parameter a finite
    gradient, and no plain version runs on the card."""
    dev = _cuda()
    model = _tiny_train(dev, seed=3)
    x = torch.from_numpy(_rng(32).random((2, 5, 32, 32)).astype(np.float32)).to(dev)
    _route.reset_counters()
    model(x, torch.tensor([1, 2], device=dev)).square().mean().backward()
    assert _route.ROUTE.plain_cuda_calls == 0
    for k, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), k
    for name in ("window_attention_bwd", "spectral_stats_bwd", "spectral_apply_bwd", "mlp_bwd",
                 "gdfn_bwd"):
        assert _route.COUNTERS[name].launches > 0, name


# ---------------------------------------------------------------------------
# remote-sensing widths (channel-chunked plans) and the window MSA kernel
# ---------------------------------------------------------------------------

def _check_fwd(fn, args, kw, tol):
    got, ref = _pair(fn, *args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and a.dtype == b.dtype, (i, a.shape, b.shape)
        assert torch.isfinite(a.float()).all(), i
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        assert err <= tol * scale, f"output {i}: {err:.3e} > {tol} * {scale:.3e}"


def _rs_cases(dev, dt):
    """The eval kernels at the widths whose whole-input plans exceed 227 KB:
    C = 384 with dh 48 (latent, fusion2) and C = 192 with dh 96 (dec1,
    refinement), on a 16x16 map."""
    r = _rng(40)
    f = lambda *s, scale=1.0: _t(_n(r, s, scale)).to(dev)  # noqa: E731
    act = lambda *s: f(*s).to(dt)  # noqa: E731
    cases = []
    for c, heads in ((384, 8), (192, 2)):
        hid = int(c * 2.66)
        cases.append((f"window C={c}", window_attention,
                      [act(1, 16, 16, c), 1 + f(c, scale=0.1), f(c, scale=0.1),
                       f(3 * c, c, scale=c ** -0.5), f(3 * c, scale=0.1),
                       f(heads, 64, 64, scale=0.02), f(c, c, scale=c ** -0.5), f(c, scale=0.1),
                       heads], dict(shift=4)))
        wq, wd = f(3 * c, c, 1, 1, scale=c ** -0.5), f(3 * c, 1, 3, 3, scale=1 / 3)
        cases.append((f"stats C={c}", spectral_stats, [act(1, 16, 16, c), wq, wd, heads],
                      dict(shift=4)))
        mlp = (1 + f(c, scale=0.1), f(c, scale=0.1), f(2 * hid, c, scale=c ** -0.5),
               f(2 * hid, scale=0.1), f(c, hid, scale=hid ** -0.5), f(c, scale=0.1))
        cases.append((f"apply+tail C={c}", spectral_apply,
                      [act(1, 16, 16, c), f(1, c, c, scale=c ** -0.5), wq, wd],
                      dict(shift=4, gate=act(1, 2, 2, c), shortcut=act(1, 16, 16, c), mlp=mlp)))
    c, half, hid = 384, 192, int(384 * 2.66)
    lw, lb = 1 + f(c, scale=0.1), f(c, scale=0.1)
    wq, wd = f(3 * c, c, 1, 1, scale=c ** -0.5), f(3 * c, 1, 3, 3, scale=1 / 3)
    x1, x2 = act(1, 16, 16, half), act(1, 16, 16, half)
    cases.append(("stats x2+LN C=384", spectral_stats, [x1, wq, wd, 8],
                  dict(x2=x2, ln_w=lw, ln_b=lb)))
    cases.append(("apply x2+LN C=384", spectral_apply, [x1, f(1, c, c, scale=c ** -0.5), wq, wd],
                  dict(x2=x2, ln_w=lw, ln_b=lb, residual=True)))
    cases.append(("gdfn+proj C=384", gdfn,
                  [act(1, 16, 16, c), lw, lb, f(2 * hid, c, 1, 1, scale=c ** -0.5),
                   f(2 * hid, 1, 3, 3, scale=1 / 3), f(c, hid, 1, 1, scale=hid ** -0.5)],
                  dict(residual=True, proj_w=f(half, c, 1, 1, scale=c ** -0.5))))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_cuda_remote_sensing_widths_match_plain(dtype, tol):
    """The channel-chunked plans against the plain versions: float32 within
    1e-4 and bf16 within 3e-2 of each output's max-abs (as chip_smoke.py);
    every plan within the device's opt-in limit."""
    from mp_hsir_tpu_torch.ops.kernels import _build

    dev = _cuda()
    faults = []
    for name, fn, args, kw in _rs_cases(dev, getattr(torch, dtype)):
        try:
            _check_fwd(fn, args, kw, tol)
        except AssertionError as e:
            faults.append(f"{name}: {e}")
    assert not faults, "\n".join(faults)
    # the window kernel: bf16 stages the whole window (its chunk is C),
    # float32 streams 64-channel chunks; every plan within the limit
    code = int(dtype == "bfloat16")
    # the bf16 apply tile has one resident plan (its chunk is C)
    for kernel, shape, want in (("window", (384, 8, code), 384 if code else 64),
                                ("spectral_stats", (192, 2), 64),
                                ("spectral_apply", (384, 1, code), 384 if code else 64),
                                ("gdfn", (384,), 64)):
        kc = _build.chunk(f"mp_{kernel}_chunk", *shape)
        entry = "mp_window_attention_smem" if kernel == "window" else f"mp_{kernel}_smem"
        assert kc == want, kernel
        assert 0 < _build.plan_bytes(entry, *shape, kc) <= _build.smem_limit(), entry


# (C, heads): dh 32, 64, 96 and 48 (an even head count: the bf16 kernel
# splits these few windows' heads over a two-block cluster), 3 heads of 32
# (one block per window); C = 36 and 27 (rows not 16-byte multiples: staged
# and stored element by element; dh 18 and 9 padded to 32 and 16; an odd C
# and an odd split point of the output columns); the maps give 3 windows
# (8x24) and, at B = 2, 12 (16x24): odd counts, and a window grid that is
# not square
WINDOW_CASES = [(c, heads, shift, b, h)
                for c, heads in ((64, 2), (128, 2), (192, 2), (384, 8), (96, 3), (36, 2), (27, 3))
                for shift in (0, 4) for b, h in ((1, 8), (2, 16))]


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,shift,b,h", WINDOW_CASES)
def test_cuda_window_attention_widths_match_plain(c, heads, shift, b, h):
    """K1 on the card against its plain version at every head width of the
    presets, shifted and not: bf16 within 3e-2 and float32 within 1e-4 of
    each output's max-abs (y and the window means)."""
    dev = _cuda()
    d = _window_inputs(50 + c, c, heads, h, 24)
    x = _t(np.concatenate([d["x"], -d["x"][:, ::-1]], axis=0)[:b]).to(dev)
    w = [_t(d["ln_w"]).to(dev), _t(d["ln_b"]).to(dev), _t(d["wqkv"]).t().to(dev),
         _t(d["bqkv"]).to(dev), _t(d["rel_bias"]).to(dev), _t(d["wp"]).t().to(dev),
         _t(d["bp"]).to(dev)]
    for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
        _route.reset_counters()
        _check_fwd(window_attention, [x.to(dt), *w, heads], dict(shift=shift), tol)
        assert _route.COUNTERS["window_attention"].launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads", [(64, 2), (256, 8), (384, 8), (96, 3), (36, 2)])
@pytest.mark.parametrize("nw", [3, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_window_msa_matches_plain(c, heads, masked, nw):
    """K14 on the card against its plain version, float32 (1e-4) and bf16
    (3e-2 of the output's max-abs): 8 windows tiling a 4-window label
    pattern, 3 windows tiling a 3-window one."""
    from mp_hsir_tpu_torch.ops.kernels.window_msa import window_msa
    from mp_hsir_tpu_torch.ops.window import shifted_window_labels

    dev = _cuda()
    r = _rng(41)
    side = (16, 16) if nw == 8 else (8, 24)
    lab = torch.as_tensor(shifted_window_labels(*side, 8, 4)).to(dev) if masked else None
    w = [_t(_u(r, s, c)).to(dev) for s in ((3 * c, c), (3 * c,), (c, c), (c,))]
    bias = _t(_n(r, (heads, 64, 64), 0.02)).to(dev)
    x = _t(_n(r, (nw, 64, c))).to(dev)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        _route.reset_counters()
        _check_fwd(window_msa, [x.to(dt), w[0], w[1], bias, w[2], w[3], heads], dict(labels=lab), tol)
        assert _route.COUNTERS["window_msa"].launches == 1


# (C, B, H): every PGSSTB width of the presets (hid = int(2.66 C), never a
# multiple of 16: the last hidden chunk is ragged; C = 96 and 192 pad the
# depth and the output channels to 128 and 192 with a half-width fc2 tile;
# C = 384 is the apply kernel's streamed plan and the widest register slice),
# on 3 tiles (8x24) and, at B = 2, 12 (16x24)
TAIL_CASES = [(c, b, h) for c in (64, 128, 256, 96, 192, 384) for b, h in ((1, 8), (2, 16))]


@pytest.mark.cuda
@pytest.mark.parametrize("c,b,h", TAIL_CASES)
def test_cuda_mlp_tail_widths_match_plain(c, b, h):
    """The tail MLP tile on the card against the plain versions: the mlp
    kernel (K6) with and without its residual and drop-path scale, and the
    spectral apply kernel's PGSSTB tail after the gate epilogue of a shifted
    block and after the x2 + LN entry; bf16 within 3e-2 and float32 within
    1e-4 of each output's max-abs. Each plan lies within the device's limit,
    and the bf16 apply plan is no larger than the float32 layout's."""
    from mp_hsir_tpu_torch.ops.kernels import _build
    from mp_hsir_tpu_torch.ops.kernels.mlp import mlp

    dev = _cuda()
    hid = int(c * 2.66)
    r = _rng(60 + c)
    f = lambda *s, scale=1.0: _t(_n(r, s, scale)).to(dev)  # noqa: E731
    weights = (1 + f(c, scale=0.1), f(c, scale=0.1), f(2 * hid, c, scale=c ** -0.5),
               f(2 * hid, scale=0.1), f(c, hid, scale=hid ** -0.5), f(c, scale=0.1))
    x, x2, short = f(b, h, 24, c), f(b, h, 24, c // 2), f(b, h, 24, c)
    gate = f(b, h // 8, 3, c, scale=0.5)
    dp = torch.tensor([1.25, 0.0][:b], device=dev)
    wq, wd = f(3 * c, c, 1, 1, scale=c ** -0.5), f(3 * c, 1, 3, 3, scale=1 / 3)
    comb = f(b, c, c, scale=c ** -0.5)
    lw, lb = 1 + f(c, scale=0.1), f(c, scale=0.1)
    for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
        code = int(dt == torch.bfloat16)
        _route.reset_counters()
        for residual in (False, True):
            for scale in (None, dp):
                _check_fwd(mlp, [x.to(dt), *weights], dict(residual=residual, dp_scale=scale), tol)
        _check_fwd(spectral_apply, [x.to(dt), comb, wq, wd],
                   dict(shift=4, gate=gate.to(dt), shortcut=short.to(dt), mlp=weights), tol)
        _check_fwd(spectral_apply, [x[..., :c - c // 2].to(dt), comb, wq, wd],
                   dict(x2=x2.to(dt), ln_w=lw, ln_b=lb, residual=True, mlp=weights), tol)
        assert _route.COUNTERS["mlp"].launches == 4
        assert _route.COUNTERS["spectral_apply"].launches == 2
        assert _route.ROUTE.plain_cuda_calls == 6
        assert 0 < _build.plan_bytes("mp_mlp_smem", c, code) <= _build.smem_limit()
        kc = _build.chunk("mp_spectral_apply_chunk", c, 1, code)
        n = _build.plan_bytes("mp_spectral_apply_smem", c, 1, code, kc)
        assert 0 < n <= _build.smem_limit()
        assert n <= _build.plan_bytes("mp_spectral_apply_smem", c, 1, 0, kc)


# The bf16 spectral apply tile (csrc/spectral_front.cuh) at every width of the
# presets' apply calls, in every variant they launch: the PGSSTB call (gate and
# shortcut, shift 0 and 4, with and without the tail), the PromptFusion call
# (x2 + LN + residual, C split in halves) and the training call (gate, drop-path
# [1.25, 0.0], shortcut); C = 36 and 27 take the element-wise staging and
# epilogue loads (rows not 16-byte multiples; 27 odd: no bf16 pairs) and pad
# to 64 and 32; on 3 tiles (8x24) and, at B = 2, 12 (16x24: a non-square
# tile grid, two images with their own comb)
FRONT_VARIANTS = ("pgsstb0", "pgsstb4", "pgsstb0+tail", "pgsstb4+tail", "fusion", "train")
FRONT_CASES = [(v, c, b, h) for v in FRONT_VARIANTS for c in (64, 128, 256, 96, 192, 384, 36, 27)
               for b, h in ((1, 8), (2, 16))]
# mp_spectral_apply_bwd_smem(C, kc) at each width's chunk (kc = C, and 64 at
# C = 384): the apply backward's plans, which the bf16 front leaves as they were
APPLY_BWD_PLANS = {64: 55904, 128: 97888, 256: 181856, 96: 76896, 192: 139872, 384: 197984}


def _front_inputs(variant, c, b, h, dev):
    """(args, kwargs) of one spectral_apply call of the variant, float32."""
    hid = int(c * 2.66)
    r = _rng(70 + c + b)
    f = lambda *s, scale=1.0: _t(_n(r, s, scale)).to(dev)  # noqa: E731
    wq, wd = f(3 * c, c, 1, 1, scale=c ** -0.5), f(3 * c, 1, 3, 3, scale=1 / 3)
    comb = f(b, c, c, scale=c ** -0.5)
    x = f(b, h, 24, c)
    gate, short = f(b, h // 8, 3, c, scale=0.5), f(b, h, 24, c)
    if variant == "fusion":
        return [x[..., :c // 2], comb, wq, wd], dict(
            x2=f(b, h, 24, c - c // 2), ln_w=1 + f(c, scale=0.1), ln_b=f(c, scale=0.1),
            residual=True)
    kw = dict(shift=4 if variant.startswith("pgsstb4") else 0, gate=gate, shortcut=short)
    if variant == "train":
        kw.update(shift=4, dp_scale=torch.tensor([1.25, 0.0][:b], device=dev))
    if variant.endswith("+tail"):
        kw["mlp"] = (1 + f(c, scale=0.1), f(c, scale=0.1), f(2 * hid, c, scale=c ** -0.5),
                     f(2 * hid, scale=0.1), f(c, hid, scale=hid ** -0.5), f(c, scale=0.1))
    return [x, comb, wq, wd], kw


def _as(dt, args, kw):
    """The call's activations (x, x2, gate, shortcut) in ``dt``."""
    kw = {k: v.to(dt) if k in ("x2", "gate", "shortcut") else v for k, v in kw.items()}
    return [args[0].to(dt)] + args[1:], kw


@pytest.mark.cuda
@pytest.mark.parametrize("variant,c,b,h", FRONT_CASES)
def test_cuda_spectral_front_matches_plain(variant, c, b, h):
    """The bf16 apply tile against the plain version, bf16 within 3e-2 and the
    float32 kernel within 1e-4 of the output's max-abs; one launch each, the
    plain version only inside the check; the bf16 plan within the device's
    limit and, with the tail, no larger than the float32 layout's at the
    same chunk; the apply backward's plans as they were."""
    from mp_hsir_tpu_torch.ops.kernels import _build

    dev = _cuda()
    args, kw = _front_inputs(variant, c, b, h, dev)
    tail = int("mlp" in kw)
    for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
        _route.reset_counters()
        _check_fwd(spectral_apply, *_as(dt, args, kw), tol)
        assert _route.COUNTERS["spectral_apply"].launches == 1
        assert _route.ROUTE.plain_cuda_calls == 1
    kc = _build.chunk("mp_spectral_apply_chunk", c, tail, 1)
    n = _build.plan_bytes("mp_spectral_apply_smem", c, tail, 1, kc)
    assert kc == c and 0 < n <= _build.smem_limit()
    if tail:  # the float32 layout holds the tail's scratch too
        assert n <= _build.plan_bytes("mp_spectral_apply_smem", c, tail, 0, kc)
    if c in APPLY_BWD_PLANS:
        kc = _build.chunk("mp_spectral_apply_bwd_chunk", c)
        assert _build.plan_bytes("mp_spectral_apply_bwd_smem", c, kc) == APPLY_BWD_PLANS[c]


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 384])
def test_cuda_spectral_front_check_sees_the_roll(c):
    """The per-call check is not blind to the roll-back: a shifted block's
    input through the bf16 tile with shift = 0 fails the 3e-2 bound against
    the plain version with shift = 4 (the model-level bound cannot see it)."""
    dev = _cuda()
    args, kw = _as(torch.bfloat16, *_front_inputs("pgsstb4", c, 2, 16, dev))
    got = spectral_apply(*args, **dict(kw, shift=0))
    with _route.plain_reference():
        ref = spectral_apply(*args, **kw)
    err = (got.float() - ref.float()).abs().max().item()
    assert err > 3e-2 * ref.float().abs().max().item(), err


# The bf16 spectral stats tile (csrc/spectral_stats.cuh) at every (C, heads)
# of the presets' stats calls (dh 32, 64, 48 and 96) and C = 36 and 27 (dh 18
# and 9 padded to 32 and 16; rows not 16-byte multiples: element-wise halo,
# weight rows padded to 40 and 32), in the variants the path launches: a
# block's stats at shift 0 and 4, the PromptFusion entry (x2 + LN, C split in
# halves); on 3 tiles (1x8x24) and 12 (2x16x24: two images, a non-square tile
# grid), and one train shape (4x64x64, shift 4: 64 tiles an image over fewer
# parts than tiles)
STATS_VARIANTS = ("shift0", "shift4", "fusion")
STATS_WIDTHS = ((64, 2), (128, 4), (128, 2), (256, 8), (96, 2), (192, 2), (384, 8), (36, 2),
                (27, 3))
STATS_CASES = ([(v, c, heads, b, h, 24) for v in STATS_VARIANTS for c, heads in STATS_WIDTHS
                for b, h in ((1, 8), (2, 16))]
               + [("shift4", c, heads, 4, 64, 64) for c, heads in STATS_WIDTHS])
# mp_spectral_stats_smem(C, heads, kc) at each width's chunk (the float32
# kernel's plans) and mp_spectral_stats_bwd_smem(C, heads), which the bf16
# tile leaves as they were
STATS_F32_PLANS = {(64, 2): 78144, (128, 4): 112448, (128, 2): 170816, (256, 8): 181056,
                   (96, 2): 122432, (192, 2): 228672, (384, 8): 167232, (36, 2): 42752,
                   (27, 3): 25652}
STATS_BWD_PLANS = {(64, 2): 68640, (128, 4): 94240, (128, 2): 136224, (256, 8): 145440,
                   (96, 2): 102432, (192, 2): 203808, (384, 8): 217632, (36, 2): 39072,
                   (27, 3): 23664}


def _stats_inputs(variant, c, heads, b, h, w, dev):
    """(args, kwargs) of one spectral_stats call of the variant, float32."""
    r = _rng(80 + c + heads + b)
    f = lambda *s, scale=1.0: _t(_n(r, s, scale)).to(dev)  # noqa: E731
    wq, wd = f(3 * c, c, 1, 1, scale=c ** -0.5), f(3 * c, 1, 3, 3, scale=1 / 3)
    x = f(b, h, w, c)
    if variant == "fusion":
        return [x[..., :c // 2], wq, wd, heads], dict(
            x2=f(b, h, w, c - c // 2), ln_w=1 + f(c, scale=0.1), ln_b=f(c, scale=0.1))
    return [x, wq, wd, heads], dict(shift=0 if variant == "shift0" else 4)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,c,heads,b,h,w", STATS_CASES)
def test_cuda_spectral_stats_matches_plain(variant, c, heads, b, h, w):
    """The bf16 stats tile and the float32 kernel against the plain version,
    bf16 within 3e-2 and float32 within 1e-4 of each output's max-abs (the
    Gram, |q|^2, |k|^2); one launch each, the plain version only inside the
    check; two calls bitwise identical; the bf16 plan within the device's
    limit, the float32 and backward plans as they were."""
    from mp_hsir_tpu_torch.ops.kernels import _build

    dev = _cuda()
    args, kw = _stats_inputs(variant, c, heads, b, h, w, dev)
    for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
        call = [args[0].to(dt)] + args[1:]
        ckw = {k: v.to(dt) if k == "x2" else v for k, v in kw.items()}
        _route.reset_counters()
        _check_fwd(spectral_stats, call, ckw, tol)
        assert _route.COUNTERS["spectral_stats"].launches == 1
        assert _route.ROUTE.plain_cuda_calls == 1
        once, again = spectral_stats(*call, **ckw), spectral_stats(*call, **ckw)
        assert all(torch.equal(u, v) for u, v in zip(once, again)), dt
    n = _build.plan_bytes("mp_spectral_stats_tc_smem", c, heads)
    assert 0 < n <= _build.smem_limit()
    kc = _build.chunk("mp_spectral_stats_chunk", c, heads)
    assert _build.plan_bytes("mp_spectral_stats_smem", c, heads, kc) == STATS_F32_PLANS[c, heads]
    assert _build.plan_bytes("mp_spectral_stats_bwd_smem", c, heads) == STATS_BWD_PLANS[c, heads]


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads", [(64, 2), (384, 8)])
def test_cuda_spectral_stats_check_sees_the_roll(c, heads):
    """The per-call check is not blind to the roll-back: a shifted block's
    input through the bf16 tile with shift = 0 gives a Gram outside the 3e-2
    bound of the plain version's with shift = 4."""
    dev = _cuda()
    args, _ = _stats_inputs("shift4", c, heads, 2, 16, 24, dev)
    x = args[0].to(torch.bfloat16)
    got = spectral_stats(x, *args[1:], shift=0)[0]
    with _route.plain_reference():
        ref = spectral_stats(x, *args[1:], shift=4)[0]
    err = (got - ref).abs().max().item()
    assert err > 3e-2 * ref.abs().max().item(), err


@pytest.mark.cuda
def test_cuda_spectral_stats_bf16_past_384_raises():
    """The bf16 stats tile takes C up to 384 and raises above it (no
    fallback); float32 streams its input in chunks and runs."""
    dev = _cuda()
    args, kw = _stats_inputs("shift4", 400, 8, 1, 8, 8, dev)
    _route.reset_counters()
    with pytest.raises(ValueError, match="C up to 384"):
        spectral_stats(args[0].to(torch.bfloat16), *args[1:], **kw)
    _check_fwd(spectral_stats, args, kw, 1e-4)
    assert _route.COUNTERS["spectral_stats"].launches == 1
