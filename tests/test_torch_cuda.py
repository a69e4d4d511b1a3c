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
    for c, heads in ((384, 8), (192, 2)):  # the bf16 window backward's two tiles
        assert 0 < _build.plan_bytes("mp_window_attention_bwd_tc_smem", c, heads) <= \
            _build.smem_limit()
        assert 0 < _build.plan_bytes("mp_window_attention_dx_tc_smem", c) <= _build.smem_limit()


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
    # the window kernel stages the whole window in both types (no chunk; the
    # float32 tile splits its 8 heads over a two-block cluster at C = 384);
    # the window MSA kernel's float32 instance (K14, SIMT) streams 64-channel
    # chunks; every plan within the limit
    code = int(dtype == "bfloat16")
    assert 0 < _build.plan_bytes("mp_window_attention_smem", 384, 8, code) <= _build.smem_limit()
    # the bf16 apply tile has one resident plan (its chunk is C)
    for c, heads in ((192, 2), (384, 8)):  # the float32 stats tile: one plan, no chunk
        assert 0 < _build.plan_bytes("mp_spectral_stats_smem", c, heads) <= _build.smem_limit()
    for kernel, shape, want in (("window", (384, 8, code), 384 if code else 64),
                                ("spectral_apply", (384, 1, code), 384 if code else 64),
                                ("gdfn", (384,), 64)):
        kc = _build.chunk(f"mp_{kernel}_chunk", *shape)
        entry = "mp_window_msa_smem" if kernel == "window" else f"mp_{kernel}_smem"
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


# The float32 window tile (window_f32_kernel, 3xTF32) at every (C, heads) of
# the presets' window calls and C = 36 / 27 (dh 18 and 9; C = 27 staged by
# element), shifted and not, on 3 windows (8x24, C = 384: a two-block cluster
# per window) and 12 (2x16x24)
WINDOW_F32_CASES = [(c, heads, shift, b, h)
                    for c, heads in ((64, 2), (128, 4), (256, 8), (128, 2), (96, 2), (192, 4),
                                     (384, 8), (192, 2), (36, 2), (27, 3))
                    for shift in (0, 4) for b, h in ((1, 8), (2, 16))]


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,shift,b,h", WINDOW_F32_CASES)
def test_cuda_window_f32_tile_matches_plain(c, heads, shift, b, h):
    """The float32 window tile on the card against window_attention_plain
    within 1e-4 of each output's max-abs (y and the window means), its
    launch counted in window_attention_f32 too; two calls bitwise equal (a
    fixed order of sums, no atomics); its plan and blocks per window equal
    to the mirror's, within the device's limit (two blocks, a cluster, only
    at C = 384, where one block's plan does not fit)."""
    import ctypes

    from mp_hsir_tpu_torch.ops.kernels import _build
    from mp_hsir_tpu_torch.ops.kernels.window_attention import window_f32_plan

    dev = _cuda()
    d = _window_inputs(150 + c, c, heads, h, 24)
    x = _t(np.concatenate([d["x"], -d["x"][:, ::-1]], axis=0)[:b]).to(dev)
    w = [_t(d["ln_w"]).to(dev), _t(d["ln_b"]).to(dev), _t(d["wqkv"]).t().to(dev),
         _t(d["bqkv"]).to(dev), _t(d["rel_bias"]).to(dev), _t(d["wp"]).t().to(dev),
         _t(d["bp"]).to(dev)]
    _route.reset_counters()
    _check_fwd(window_attention, [x, *w, heads], dict(shift=shift), 1e-4)
    assert _route.COUNTERS["window_attention_f32"].launches == 1
    assert _route.ROUTE.plain_cuda_calls == 1
    got = window_attention(x, *w, heads, shift=shift)
    again = window_attention(x, *w, heads, shift=shift)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    limit, static = _build.smem_limit(), 256  # static: the window's 64 labels
    pl = window_f32_plan(c, heads, limit - static)
    assert _build.plan_bytes("mp_window_attention_smem", c, heads, 0) == pl["bytes"] + static
    assert pl["bytes"] + static <= limit
    fn = _build.lib().mp_window_cluster
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_int
    blocks = fn(c, heads, 0, b * (h // 8) * 3, 0)
    assert blocks == pl["blocks"] == (2 if c == 384 else 1)


@pytest.mark.cuda
def test_cuda_window_f32_without_a_plan_raises():
    """A float32 width with no plan (C 256 with 2 heads of 128: neither the
    one-block nor the split plan fits) raises before any launch, as a head
    width past 128 does."""
    dev = _cuda()
    for c, heads in ((256, 2), (258, 2)):
        d = _window_inputs(7, c, heads, 8, 16)
        args = [_t(d[k]).to(dev) for k in ("x", "ln_w", "ln_b")]
        args += [_t(d["wqkv"]).t().to(dev), _t(d["bqkv"]).to(dev), _t(d["rel_bias"]).to(dev),
                 _t(d["wp"]).t().to(dev), _t(d["bp"]).to(dev)]
        _route.reset_counters()
        with pytest.raises(ValueError):
            window_attention(*args, heads)
        assert _route.COUNTERS["window_attention_f32"].launches == 0


# The float32 conv3 tile (c3_tf32_chunk, 3xTF32) at every conv3 call of the
# presets' forwards, on a 16x24 map (Cin 31: the halo staged by element;
# Cin 100: a ragged last chunk; Cout 31 and 100: a ragged last tile)
CONV3_F32_CASES = [(31, 64, "plain"), (64, 32, "down"), (128, 64, "down"), (256, 512, "up"),
                   (128, 256, "up"), (128, 128, "plain"), (64, 64, "plain"), (128, 31, "res"),
                   (100, 96, "plain"), (96, 48, "down"), (192, 96, "down"), (384, 768, "up"),
                   (192, 384, "up"), (192, 192, "plain"), (96, 96, "plain"), (192, 100, "res")]


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,mode", CONV3_F32_CASES)
def test_cuda_conv3_f32_tile_matches_plain(cin, cout, mode):
    """The float32 conv3 tile on the card against conv3_plain (TF32 off)
    within 1e-4 of the output's max-abs, its launch counted in conv3_f32
    too; two calls bitwise equal; its plan the mirror's, 101,952 B."""
    from mp_hsir_tpu_torch.ops.kernels import _build
    from mp_hsir_tpu_torch.ops.kernels.conv3 import conv3_plan

    dev = _cuda()
    rng = _rng(260 + cin + cout)
    x = _t(_n(rng, (1, 16, 24, cin))).to(dev)
    wt = _t(_u(rng, (cout, cin, 3, 3), 9 * cin)).to(dev)
    res = _t(_n(rng, (1, 16, 24, cout))).to(dev) if mode == "res" else None
    _route.reset_counters()
    _check_fwd(conv3, [x, wt, mode, res], {}, 1e-4)
    assert _route.COUNTERS["conv3_f32"].launches == 1
    assert torch.equal(conv3(x, wt, mode, res), conv3(x, wt, mode, res))
    assert _build.plan_bytes("mp_conv3_smem", 0) == conv3_plan(torch.float32) == 101952
    assert _build.plan_bytes("mp_conv3_smem", 1) == conv3_plan(torch.bfloat16) == 101952


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


# The float32 tail tile (mlp_tail_f32, 3xTF32) at every PGSSTB width of the
# presets and at C = 400 (CK 448: two output groups, 384 + 64 channels; C %
# 8 != 0 is covered by C = 36 in the front cases), on 3 tiles (8x24) and 12
# (2x16x24)
TAIL_F32_CASES = [(c, b, h) for c in (64, 128, 256, 96, 192, 384, 400)
                  for b, h in ((1, 8), (2, 16))]


@pytest.mark.cuda
@pytest.mark.parametrize("c,b,h", TAIL_F32_CASES)
def test_cuda_mlp_tail_f32_matches_plain(c, b, h):
    """The float32 tail tile on the card against the plain versions within
    1e-4 of each output's max-abs: K6 with and without its residual and
    drop-path scale, and the spectral apply kernel's tail after a shifted
    block's gate epilogue and after the x2 + LN entry; every launch counted
    in mlp_tail_f32 too; two calls bitwise equal (no float atomics); the mlp
    plan equal to the mirror's, the apply plan holding the tail's scratch,
    both within the device's limit."""
    from mp_hsir_tpu_torch.ops.kernels import _build
    from mp_hsir_tpu_torch.ops.kernels.mlp import mlp, tail_f32_plan

    dev = _cuda()
    hid = int(c * 2.66)
    r = _rng(160 + c)
    f = lambda *s, scale=1.0: _t(_n(r, s, scale)).to(dev)  # noqa: E731
    weights = (1 + f(c, scale=0.1), f(c, scale=0.1), f(2 * hid, c, scale=c ** -0.5),
               f(2 * hid, scale=0.1), f(c, hid, scale=hid ** -0.5), f(c, scale=0.1))
    x, x2, short = f(b, h, 24, c), f(b, h, 24, c // 2), f(b, h, 24, c)
    gate = f(b, h // 8, 3, c, scale=0.5)
    dp = torch.tensor([1.25, 0.0][:b], device=dev)
    wq, wd = f(3 * c, c, 1, 1, scale=c ** -0.5), f(3 * c, 1, 3, 3, scale=1 / 3)
    comb = f(b, c, c, scale=c ** -0.5)
    lw, lb = 1 + f(c, scale=0.1), f(c, scale=0.1)
    _route.reset_counters()
    for residual in (False, True):
        for scale in (None, dp):
            _check_fwd(mlp, [x, *weights], dict(residual=residual, dp_scale=scale), 1e-4)
    apply_kw = dict(shift=4, gate=gate, shortcut=short, mlp=weights)
    _check_fwd(spectral_apply, [x, comb, wq, wd], apply_kw, 1e-4)
    _check_fwd(spectral_apply, [x[..., :c - c // 2], comb, wq, wd],
               dict(x2=x2, ln_w=lw, ln_b=lb, residual=True, mlp=weights), 1e-4)
    assert _route.COUNTERS["mlp_tail_f32"].launches == 6
    assert _route.ROUTE.plain_cuda_calls == 6
    assert torch.equal(mlp(x, *weights, residual=True, dp_scale=dp),
                       mlp(x, *weights, residual=True, dp_scale=dp))
    assert torch.equal(spectral_apply(x, comb, wq, wd, **apply_kw),
                       spectral_apply(x, comb, wq, wd, **apply_kw))
    pl = tail_f32_plan(c, hid)
    assert _build.plan_bytes("mp_mlp_smem", c, 0) == pl["bytes"] <= _build.smem_limit()
    kc = _build.chunk("mp_spectral_apply_chunk", c, 1, 0)
    n = _build.plan_bytes("mp_spectral_apply_smem", c, 1, 0, kc)
    assert pl["bytes"] < n <= _build.smem_limit()


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
# mp_spectral_stats_smem(C, heads): the float32 tile's plans (static
# included, as stats_f32_plan mirrors them), and mp_spectral_stats_bwd_smem(C,
# heads), which the bf16 tile leaves as they were
STATS_F32_PLANS = {(64, 2): 153152, (128, 4): 153152, (128, 2): 161344, (256, 8): 203840,
                   (96, 2): 209984, (192, 2): 228416, (384, 8): 209984, (36, 2): 153152,
                   (27, 3): 124736, (400, 8): 161344}
STATS_BWD_PLANS = {(64, 2): 68640, (128, 4): 94240, (128, 2): 136224, (256, 8): 145440,
                   (96, 2): 102432, (192, 2): 203808, (384, 8): 217632, (36, 2): 39072,
                   (27, 3): 23664, (192, 4): 140832}


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
    """The bf16 stats tile and the float32 tile against the plain version,
    bf16 within 3e-2 and float32 within 1e-4 of each output's max-abs (the
    Gram, |q|^2, |k|^2); one launch each (the float32 one counted in
    spectral_stats_f32 too), the plain version only inside the check; two
    calls bitwise identical; the bf16 plan within the device's limit, the
    float32 tile's plan the mirror's, the backward plans as they were."""
    from mp_hsir_tpu_torch.ops.kernels import _build
    from mp_hsir_tpu_torch.ops.kernels.spectral import stats_f32_plan

    dev = _cuda()
    args, kw = _stats_inputs(variant, c, heads, b, h, w, dev)
    for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
        call = [args[0].to(dt)] + args[1:]
        ckw = {k: v.to(dt) if k == "x2" else v for k, v in kw.items()}
        _route.reset_counters()
        _check_fwd(spectral_stats, call, ckw, tol)
        assert _route.COUNTERS["spectral_stats"].launches == 1
        assert _route.COUNTERS["spectral_stats_f32"].launches == int(dt == torch.float32)
        assert _route.ROUTE.plain_cuda_calls == 1
        once, again = spectral_stats(*call, **ckw), spectral_stats(*call, **ckw)
        assert all(torch.equal(u, v) for u, v in zip(once, again)), dt
    n = _build.plan_bytes("mp_spectral_stats_tc_smem", c, heads)
    assert 0 < n <= _build.smem_limit()
    n32 = _build.plan_bytes("mp_spectral_stats_smem", c, heads)
    assert n32 == STATS_F32_PLANS[c, heads] == stats_f32_plan(c, heads)["bytes"]
    assert n32 <= _build.smem_limit()
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
    fallback); float32 runs its tile there (8 heads of 50, one a group)."""
    from mp_hsir_tpu_torch.ops.kernels import _build

    dev = _cuda()
    args, kw = _stats_inputs("shift4", 400, 8, 1, 8, 8, dev)
    _route.reset_counters()
    with pytest.raises(ValueError, match="C up to 384"):
        spectral_stats(args[0].to(torch.bfloat16), *args[1:], **kw)
    _check_fwd(spectral_stats, args, kw, 1e-4)
    assert _route.COUNTERS["spectral_stats"].launches == 1
    assert _route.COUNTERS["spectral_stats_f32"].launches == 1
    assert _build.plan_bytes("mp_spectral_stats_smem", 400, 8) == STATS_F32_PLANS[400, 8]


@pytest.mark.cuda
def test_cuda_spectral_stats_f32_past_96_wide_heads_raises():
    """The float32 stats tile takes heads up to 96 wide (a head's q|k columns
    in one group) and raises past that before any launch (no fallback)."""
    dev = _cuda()
    args, kw = _stats_inputs("shift0", 256, 2, 1, 8, 8, dev)
    _route.reset_counters()
    with pytest.raises(ValueError, match="heads up to 96"):
        spectral_stats(*args, **kw)
    assert _route.COUNTERS["spectral_stats_f32"].launches == 0


def _ptxas(kernel: str) -> dict:
    """Registers and spill bytes of one kernel from nvcc's -Xptxas -v report
    of the library's build (this process's, or the build log beside it)."""
    import os
    import re

    from mp_hsir_tpu_torch.ops.kernels import _build

    _build.lib()
    log = _build.BUILD_INFO.get("log")
    if log is None:
        with open(os.path.join(_build.BUILD_DIR, "build.log")) as fh:
            log = fh.read()
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            rep = {}
            for nxt in lines[i + 1:i + 6]:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", nxt)
                if m:
                    rep.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    rep["registers"] = int(m.group(1))
                    break
            return rep
    raise AssertionError(f"{kernel}: not in the build's ptxas report")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["spectral_stats_f32_kernel",
                                    "dwconv_dx_tc_kernelILb1ELb0ELb0E"])
def test_cuda_stats_tiles_registers(kernel):
    """The float32 stats tile and K10a's stencil tile (dwconv_dx_tc_kernel<true,
    false, false>, guarded since the bf16 backward tiles) within 128 registers
    (512 threads a block) and without spills."""
    _cuda()
    rep = _ptxas(kernel)
    assert rep["registers"] <= 128, rep
    assert rep.get("spill_stores", 0) == 0 and rep.get("spill_loads", 0) == 0, rep


# The bf16 GDFN tile (gdfn_tc_kernel, csrc/gdfn.cu) at every (C, hid, Co) of
# the presets' calls (hid 340 and 510 pad w_out's rows, 1021 pads to 1024;
# the last hidden chunk is ragged at every width; C = 384 holds the widest
# register slice) and C = 36 and 27 (element-wise halo and stores, w_in's rows
# padded to 40 and 32, an odd C and Co), with and without the residual and
# the exit 1x1, on 3 tiles (1x8x24) and 24 (2x16x48: two images, a non-square
# tile grid)
GDFN_WIDTHS = ((128, 340, 64), (256, 680, 128), (192, 510, 96), (384, 1021, 192), (36, 95, 18),
               (27, 71, 13))
GDFN_CASES = [(c, hid, co, residual, proj, b, h, w) for c, hid, co in GDFN_WIDTHS
              for residual, proj in ((False, False), (True, False), (True, True), (False, True))
              for b, h, w in ((1, 8, 24), (2, 16, 48))]
# mp_gdfn_tc_smem(C) (GdfnPlan, static included: 4 ring stages at every
# width), and the plans the tile leaves as they were: mp_gdfn_smem(C, kc) and
# mp_gdfn_bwd_smem(C, kc) at each width's chunk (64 at C = 384, else C)
GDFN_TC_PLANS = {128: 172864, 256: 201536, 192: 187200, 384: 230208, 36: 158528, 27: 151360}
GDFN_F32_PLANS = {128: 119872, 256: 203840, 192: 161856, 384: 159808, 36: 59520, 27: 53616}
GDFN_BWD_PLANS = {128: 127264, 256: 211232, 192: 169248, 384: 168000, 36: 66912, 27: 61008}


def _gdfn_inputs(c, hid, co, proj, b, h, w, dev):
    """(args, kwargs) of one gdfn call, float32."""
    r = _rng(90 + c + b)
    f = lambda *s, scale=1.0: _t(_n(r, s, scale)).to(dev)  # noqa: E731
    args = [f(b, h, w, c), 1 + f(c, scale=0.1), f(c, scale=0.1),
            f(2 * hid, c, 1, 1, scale=c ** -0.5), f(2 * hid, 1, 3, 3, scale=1 / 3),
            f(c, hid, 1, 1, scale=hid ** -0.5)]
    return args, dict(proj_w=f(co, c, 1, 1, scale=c ** -0.5) if proj else None)


@pytest.mark.cuda
@pytest.mark.parametrize("c,hid,co,residual,proj,b,h,w", GDFN_CASES)
def test_cuda_gdfn_tile_matches_plain(c, hid, co, residual, proj, b, h, w):
    """The bf16 tile and the float32 kernel against the plain version, bf16
    within 3e-2 and float32 within 1e-4 of the output's max-abs; one launch
    each, the plain version only inside the check; two calls bitwise equal
    (no cross-block sums); the bf16 plan pinned and within the device's
    limit, the float32 forward and backward plans as they were."""
    from mp_hsir_tpu_torch.ops.kernels import _build

    dev = _cuda()
    args, kw = _gdfn_inputs(c, hid, co, proj, b, h, w, dev)
    kw["residual"] = residual
    for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
        call = [args[0].to(dt)] + args[1:]
        _route.reset_counters()
        _check_fwd(gdfn, call, kw, tol)
        assert _route.COUNTERS["gdfn"].launches == 1
        assert _route.ROUTE.plain_cuda_calls == 1
        assert torch.equal(gdfn(*call, **kw), gdfn(*call, **kw)), dt
    n = _build.plan_bytes("mp_gdfn_tc_smem", c)
    assert n == GDFN_TC_PLANS[c] and n <= _build.smem_limit()
    kc = _build.chunk("mp_gdfn_chunk", c)
    assert _build.plan_bytes("mp_gdfn_smem", c, kc) == GDFN_F32_PLANS[c]
    kc = _build.chunk("mp_gdfn_bwd_chunk", c)
    assert _build.plan_bytes("mp_gdfn_bwd_smem", c, kc) == GDFN_BWD_PLANS[c]


@pytest.mark.cuda
@pytest.mark.parametrize("c,hid,co", [(128, 340, 64), (384, 1021, 192)])
def test_cuda_gdfn_check_sees_the_gate(c, hid, co):
    """The per-call check is not blind to the gate's side: the tile given
    w_in and w_dw with their x1 and x2 halves swapped (x1 * gelu(x2), the tail
    tile's gate) fails the 3e-2 bound against the plain version."""
    dev = _cuda()
    args, kw = _gdfn_inputs(c, hid, co, True, 2, 16, 24, dev)
    x = args[0].to(torch.bfloat16)
    swap = [torch.cat([wt[hid:], wt[:hid]]) for wt in args[3:5]]
    got = gdfn(x, *args[1:3], *swap, args[5], residual=True, **kw)
    with _route.plain_reference():
        ref = gdfn(x, *args[1:], residual=True, **kw)
    err = (got.float() - ref.float()).abs().max().item()
    assert err > 3e-2 * ref.float().abs().max().item(), err


@pytest.mark.cuda
def test_cuda_gdfn_bf16_past_384_raises():
    """The bf16 tile takes C and Co up to 384 and raises above them (no
    fallback); float32 streams its input in chunks and runs."""
    dev = _cuda()
    args, kw = _gdfn_inputs(400, 1064, 0, False, 1, 8, 8, dev)
    _route.reset_counters()
    with pytest.raises(ValueError, match="C and Co up to 384"):
        gdfn(args[0].to(torch.bfloat16), *args[1:], **kw)
    _check_fwd(gdfn, args, kw, 1e-4)
    assert _route.COUNTERS["gdfn"].launches == 1
    args, kw = _gdfn_inputs(128, 340, 400, True, 1, 8, 8, dev)
    with pytest.raises(ValueError, match="C and Co up to 384"):
        gdfn(args[0].to(torch.bfloat16), *args[1:], **kw)


# The bf16 MLP backward tile (mlp_bwd_tc_kernel, csrc/mlp.cu) at every preset
# width (the last hidden chunk ragged at each; hid 255 and 1021 odd: dh's
# g-half starts at an odd column) and C = 36 and 27 (element-wise staging,
# CK 64), on 3 tiles (1x8x24) and 24 (2x16x48: two images with drop-path
# scales [1.25, 0.0], a non-square tile grid)
MLP_BWD_WIDTHS = ((64, 170), (128, 340), (256, 680), (96, 255), (192, 510), (384, 1021),
                  (36, 95), (27, 71))
MLP_BWD_CASES = [(c, hid, b, h, w) for c, hid in MLP_BWD_WIDTHS
                 for b, h, w in ((1, 8, 24), (2, 16, 48))]
# mp_mlp_bwd_tc_smem(C): MlpBwdPlan's bytes (4 ring stages, 3 at C = 384)
# and block_sum's 64 static bytes; and the float32 backward's plans, which the
# tile leaves as they were: mp_mlp_bwd_smem(C, kc) at its chunk (64 at C = 384)
MLP_BWD_TC_PLANS = {64: 121408, 128: 145984, 256: 195136, 96: 145984, 192: 170560,
                    384: 225856, 36: 121408, 27: 121408}
MLP_BWD_F32_PLANS = {64: 99648, 128: 132416, 256: 197952, 96: 116032, 192: 165184,
                     384: 116800, 36: 85312, 27: 80704}


def _mlp_bwd_inputs(c, hid, b, h, w, dev):
    """(x, the six weights, dy), float32."""
    r = _rng(110 + c + b)
    f = lambda *s, scale=1.0: _t(_n(r, s, scale)).to(dev)  # noqa: E731
    return f(b, h, w, c), (1 + f(c, scale=0.1), f(c, scale=0.1), f(2 * hid, c, scale=c ** -0.5),
                           f(2 * hid, scale=0.1), f(c, hid, scale=hid ** -0.5),
                           f(c, scale=0.1)), f(b, h, w, c)


def _outputs_close(got, ref, tol, what):
    for i, (a, r) in enumerate(zip(got, ref)):
        assert (a is None) == (r is None), (what, i)
        if r is None:
            continue
        assert a.shape == r.shape and a.dtype == r.dtype, (what, i, a.shape, r.shape)
        assert torch.isfinite(a.float()).all(), (what, i)
        err = (a.float() - r.float()).abs().max().item()
        scale = r.float().abs().max().item()
        assert err <= tol * scale, f"{what} output {i}: {err:.3e} > {tol} * {scale:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("c,hid,b,h,w", MLP_BWD_CASES)
def test_cuda_mlp_bwd_tile_matches_plain(c, hid, b, h, w, monkeypatch):
    """The MLP backward on the card against mlp_bwd_plain, every output, with
    and without the residual and the drop-path scale: bf16 (the tile) within
    3e-2 and float32 (mlp_bwd_kernel + ln_linear_bwd, SIMT) within 1e-4 of each
    output's max-abs. One counted launch per call; the bf16 route launches no
    ln_linear_bwd; two bf16 calls give bitwise the same outputs (no float
    atomics). The tile's plan pinned, within the device's limit; the float32
    plans as they were."""
    from mp_hsir_tpu_torch.ops.kernels import _build, mlp as mlp_mod

    dev = _cuda()
    x, weights, dy = _mlp_bwd_inputs(c, hid, b, h, w, dev)
    ln_calls = []
    ln_linear = mlp_mod.ln_linear_bwd
    monkeypatch.setattr(mlp_mod, "ln_linear_bwd",
                        lambda *a, **k: ln_calls.append(1) or ln_linear(*a, **k))
    for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
        for residual in (False, True):
            for dp in (None, torch.tensor([1.25, 0.0][:b], device=dev)):
                call = (x.to(dt), *weights, dp, residual, 1e-5, dy.to(dt))
                what = f"{dt} residual={residual} dp={dp is not None}"
                _route.reset_counters()
                ln_calls.clear()
                got = mlp_mod._bwd_launch(*call)
                assert _route.COUNTERS["mlp_bwd"].launches == 1, what
                assert len(ln_calls) == (0 if dt == torch.bfloat16 else 1), what
                _outputs_close(got, mlp_mod.mlp_bwd_plain(*call), tol, what)
                if dt == torch.bfloat16:
                    again = mlp_mod._bwd_launch(*call)
                    assert all(a is None or torch.equal(a, r) for a, r in zip(got, again)), what
    n = _build.plan_bytes("mp_mlp_bwd_tc_smem", c)
    assert n == MLP_BWD_TC_PLANS[c] and n <= _build.smem_limit()
    kc = _build.chunk("mp_mlp_bwd_chunk", c)
    assert _build.plan_bytes("mp_mlp_bwd_smem", c, kc) == MLP_BWD_F32_PLANS[c]


@pytest.mark.cuda
@pytest.mark.parametrize("c,hid", [(128, 340), (384, 1021)])
def test_cuda_mlp_bwd_check_sees_the_gate(c, hid):
    """The per-call check is not blind to the packed slab's a|g order: the
    tile given fc1 with its a and g halves swapped (w1's rows and b1) fails
    the 3e-2 bound on dx against the plain backward of the weights as they
    are."""
    from mp_hsir_tpu_torch.ops.kernels import mlp as mlp_mod

    dev = _cuda()
    x, (lw, lb, w1, b1, w2, b2), dy = _mlp_bwd_inputs(c, hid, 2, 16, 24, dev)
    x, dy = x.to(torch.bfloat16), dy.to(torch.bfloat16)
    dp = torch.tensor([1.25, 0.0], device=dev)
    swap = lambda t: torch.cat([t[hid:], t[:hid]])  # noqa: E731
    got = mlp_mod._bwd_launch(x, lw, lb, swap(w1), swap(b1), w2, b2, dp, True, 1e-5, dy)[0]
    ref = mlp_mod.mlp_bwd_plain(x, lw, lb, w1, b1, w2, b2, dp, True, 1e-5, dy)[0]
    err = (got.float() - ref.float()).abs().max().item()
    assert err > 3e-2 * ref.float().abs().max().item(), err


@pytest.mark.cuda
def test_cuda_mlp_bwd_bf16_past_384_raises():
    """The bf16 tile takes C up to 384 and raises above it (no fallback);
    float32 streams its input in chunks and runs."""
    from mp_hsir_tpu_torch.ops.kernels import mlp as mlp_mod

    dev = _cuda()
    x, weights, dy = _mlp_bwd_inputs(400, 1064, 1, 8, 8, dev)
    with pytest.raises(ValueError, match="C up to 384"):
        mlp_mod._bwd_launch(x.to(torch.bfloat16), *weights, None, True, 1e-5,
                            dy.to(torch.bfloat16))
    _outputs_close(mlp_mod._bwd_launch(x, *weights, None, True, 1e-5, dy),
                   mlp_mod.mlp_bwd_plain(x, *weights, None, True, 1e-5, dy), 1e-4, "float32")


# The bf16 spectral stats backward (K10a): spectral_stats_bwd_tc_kernel
# (csrc/spectral_stats.cuh) and dwconv_dx_tc_kernel (csrc/dwconv_dx.cuh) at
# every (C, heads) of STATS_WIDTHS and the remote-sensing step's (192, 4),
# shift 0 and 4, LN on and off, on 3 tiles (1x8x24) and 12 (2x16x24: two
# images, a non-square tile grid)
STATS_BWD_CASES = [(c, heads, b, h) for c, heads in STATS_WIDTHS + ((192, 4),)
                   for b, h in ((1, 8), (2, 16))]


def _stats_bwd_inputs(c, heads, b, h, w, dev):
    """((x, wqkv, wdw), (ln_w, ln_b), (dgram, dnq, dnk)), float32."""
    r = _rng(130 + c + heads + b)
    f = lambda *s, scale=1.0: _t(_n(r, s, scale)).to(dev)  # noqa: E731
    dh = c // heads
    return ((f(b, h, w, c), f(3 * c, c, 1, 1, scale=c ** -0.5), f(3 * c, 1, 3, 3, scale=1 / 3)),
            (1 + f(c, scale=0.1), f(c, scale=0.1)),
            (f(b, c, dh, scale=0.05), f(b, heads, dh, scale=0.05), f(b, heads, dh, scale=0.05)))


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,b,h", STATS_BWD_CASES)
def test_cuda_spectral_stats_bwd_tiles_match_plain(c, heads, b, h, monkeypatch):
    """The stats backward on the card against spectral_stats_bwd_plain, every
    output: bf16 (the two tiles, wgrad, one sum_parts) within 3e-2 and float32
    (mp_spectral_stats_bwd + dwconv_bwd + ln_linear_bwd, SIMT) within 1e-4 of
    each output's max-abs. One counted launch per call; the bf16 route
    launches each tile once and no dwconv_bwd or ln_linear_bwd; two bf16 calls
    give bitwise the same outputs (no float atomics). Both tiles' plans
    within the device's limit, each at most its mirror's dynamic bytes plus
    the static; the float32 plan as it was."""
    from mp_hsir_tpu_torch.ops.kernels import _build, spectral as sp

    dev = _cuda()
    (x, wq, wd), (lw, lb), cots = _stats_bwd_inputs(c, heads, b, h, 24, dev)
    calls = []
    for name in ("dwconv_bwd", "ln_linear_bwd"):
        fn = getattr(sp, name)
        monkeypatch.setattr(sp, name,
                            lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    get = sp._stats_entry

    def counted(kind="fwd"):
        fn = get(kind)
        return lambda *a: calls.append(fn.__name__) or fn(*a)

    monkeypatch.setattr(sp, "_stats_entry", counted)
    for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
        bf16 = dt == torch.bfloat16
        for shift in (0, 4):
            for ln in (False, True):
                call = (x.to(dt), wq, wd, heads, shift, lw if ln else None, lb if ln else None,
                        1e-5, *cots)
                what = f"{dt} shift={shift} ln={ln}"
                _route.reset_counters()
                calls.clear()
                got = sp._stats_bwd_launch(*call)
                assert _route.COUNTERS["spectral_stats_bwd"].launches == 1, what
                assert calls == (["mp_spectral_stats_bwd_tc", "mp_dwconv_dx_tc"] if bf16 else
                                 ["mp_spectral_stats_bwd", "dwconv_bwd", "ln_linear_bwd"]), what
                _outputs_close(got, sp.spectral_stats_bwd_plain(*call), tol, what)
                if bf16:
                    again = sp._stats_bwd_launch(*call)
                    assert all(a is None or torch.equal(a, r) for a, r in zip(got, again)), what
    pl, limit = sp.stats_bwd_tc_plan(c, heads), _build.smem_limit()
    n1 = _build.plan_bytes("mp_spectral_stats_bwd_tc_smem", c, heads)
    n2 = _build.plan_bytes("mp_dwconv_dx_tc_smem", c, 2 * c)
    assert pl["bytes"] < n1 <= min(pl["bytes"] + 1024, limit), n1
    assert pl["dx"]["bytes"] < n2 <= min(pl["dx"]["bytes"] + 1024, limit), n2
    assert _build.plan_bytes("mp_spectral_stats_bwd_smem", c, heads) == STATS_BWD_PLANS[c, heads]


@pytest.mark.cuda
def test_cuda_spectral_stats_bwd_bf16_past_384_raises():
    """The bf16 stats backward takes C up to 384 and raises above it (no
    fallback); float32 runs its SIMT kernels."""
    from mp_hsir_tpu_torch.ops.kernels import spectral as sp

    dev = _cuda()
    (x, wq, wd), (lw, lb), cots = _stats_bwd_inputs(400, 8, 1, 8, 8, dev)
    with pytest.raises(ValueError, match="C up to 384"):
        sp._stats_bwd_launch(x.to(torch.bfloat16), wq, wd, 8, 4, lw, lb, 1e-5, *cots)
    call = (x, wq, wd, 8, 4, lw, lb, 1e-5, *cots)
    _outputs_close(sp._stats_bwd_launch(*call), sp.spectral_stats_bwd_plain(*call), 1e-4,
                   "float32")


# The bf16 spectral apply backward (K10b): spectral_apply_bwd_tc_kernel
# (csrc/spectral_apply_bwd.cuh) and dwconv_dx_tc_kernel<true, true> at K = C
# at every preset width and C = 36 and 27, in the call shapes of the train
# steps: the PGSSTB call (gate with drop-path [1.25, 0.0] at shift 0 and 4,
# and without drop-path) and the TransformerBlock call (LN, residual); on 3
# tiles (1x8x24) and 12 (2x16x24: two images, a non-square tile grid)
APPLY_BWD_CASES = [(c, b, h) for c in (64, 128, 256, 96, 192, 384, 36, 27)
                   for b, h in ((1, 8), (2, 16))]
APPLY_BWD_CALLS = (dict(gate=True, dp=True, shift=0), dict(gate=True, dp=True, shift=4),
                   dict(gate=True, dp=False, shift=4), dict(ln=True, residual=True, shift=0))


def _apply_bwd_inputs(c, b, h, w, dev):
    """((x, comb, wqkv, wdw), (ln_w, ln_b), gate, dy), float32."""
    r = _rng(150 + c + b)
    f = lambda *s, scale=1.0: _t(_n(r, s, scale)).to(dev)  # noqa: E731
    return ((f(b, h, w, c), f(b, c, c, scale=c ** -0.5), f(3 * c, c, 1, 1, scale=c ** -0.5),
             f(3 * c, 1, 3, 3, scale=1 / 3)), (1 + f(c, scale=0.1), f(c, scale=0.1)),
            f(b, h // 8, w // 8, c, scale=0.5), f(b, h, w, c))


@pytest.mark.cuda
@pytest.mark.parametrize("c,b,h", APPLY_BWD_CASES)
def test_cuda_spectral_apply_bwd_tiles_match_plain(c, b, h, monkeypatch):
    """The apply backward on the card against spectral_apply_bwd_plain, every
    output: bf16 (the two tiles, d gate, wgrad, the part sums) within 3e-2
    and float32 (mp_spectral_apply_bwd + dwconv_bwd + ln_linear_bwd, SIMT)
    within 1e-4 of each output's max-abs. One counted launch per call; the
    bf16 route launches tile 1, d gate where there is a gate, and tile 2, and
    no dwconv_bwd or ln_linear_bwd; two bf16 calls give bitwise the same
    outputs (no float atomics). Both tiles' plans within the device's limit,
    each at most its mirror's dynamic bytes plus the static; the float32
    plan as it was."""
    from mp_hsir_tpu_torch.ops.kernels import _build, spectral as sp

    dev = _cuda()
    (x, comb, wq, wd), (lw, lb), gate, dy = _apply_bwd_inputs(c, b, h, 24, dev)
    dps = torch.tensor([1.25, 0.0][:b], device=dev)
    calls = []
    for name in ("dwconv_bwd", "ln_linear_bwd"):
        fn = getattr(sp, name)
        monkeypatch.setattr(sp, name,
                            lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    get = sp._apply_entry

    def counted(kind="fwd"):
        fn = get(kind)
        return lambda *a: calls.append(fn.__name__) or fn(*a)

    monkeypatch.setattr(sp, "_apply_entry", counted)
    for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
        bf16 = dt == torch.bfloat16
        for kw in APPLY_BWD_CALLS:
            ln, g = kw.get("ln", False), kw.get("gate", False)
            call = (x.to(dt), comb, wq, wd, kw["shift"], lw if ln else None, lb if ln else None,
                    kw.get("residual", False), gate.to(dt) if g else None,
                    dps if kw.get("dp") else None, 1e-5, dy.to(dt))
            what = f"{dt} {kw}"
            _route.reset_counters()
            calls.clear()
            got = sp._apply_bwd_launch(*call)
            assert _route.COUNTERS["spectral_apply_bwd"].launches == 1, what
            want = (["mp_spectral_apply_bwd_tc"] + ["mp_spectral_gate_grad"] * g
                    + ["mp_spectral_apply_dx_tc"] if bf16 else
                    ["mp_spectral_apply_bwd", "dwconv_bwd", "ln_linear_bwd"])
            assert calls == want, (what, calls)
            _outputs_close(got, sp.spectral_apply_bwd_plain(*call), tol, what)
            if bf16:
                again = sp._apply_bwd_launch(*call)
                assert all(a is None or torch.equal(a, r) for a, r in zip(got, again)), what
    pl, limit = sp.apply_bwd_tc_plan(c), _build.smem_limit()
    n1 = _build.plan_bytes("mp_spectral_apply_bwd_tc_smem", c, 1)
    n2 = _build.plan_bytes("mp_spectral_apply_bwd_tc_smem", c, 2)
    assert pl["bytes"] < n1 <= min(pl["bytes"] + 1024, limit), n1
    assert pl["dx"]["bytes"] < n2 <= min(pl["dx"]["bytes"] + 1024, limit), n2
    if c in APPLY_BWD_PLANS:
        kc = _build.chunk("mp_spectral_apply_bwd_chunk", c)
        assert _build.plan_bytes("mp_spectral_apply_bwd_smem", c, kc) == APPLY_BWD_PLANS[c]


@pytest.mark.cuda
def test_cuda_spectral_apply_bwd_bf16_past_384_raises():
    """The bf16 apply backward takes C up to 384 and raises above it (no
    fallback); float32 runs its SIMT kernels."""
    from mp_hsir_tpu_torch.ops.kernels import spectral as sp

    dev = _cuda()
    (x, comb, wq, wd), _, gate, dy = _apply_bwd_inputs(400, 1, 8, 8, dev)
    with pytest.raises(ValueError, match="C up to 384"):
        sp._apply_bwd_launch(x.to(torch.bfloat16), comb, wq, wd, 4, None, None, False,
                             gate.to(torch.bfloat16), None, 1e-5, dy.to(torch.bfloat16))
    call = (x, comb, wq, wd, 4, None, None, False, gate, None, 1e-5, dy)
    _outputs_close(sp._apply_bwd_launch(*call), sp.spectral_apply_bwd_plain(*call), 1e-4,
                   "float32")


# The bf16 GDFN backward (K11): gdfn_bwd_tc_kernel (csrc/gdfn.cu) and
# dwconv_dx_tc_kernel<true, true, true> at K = 2 hid (float32 t) at every (C,
# hid) of both presets' train steps (hid 1021: x2's columns at an odd
# offset, K = 2042 not a multiple of 4) and C = 36 and 27 (element-wise x and
# dy, w_in's rows padded to 40 and 32), with and without the residual, on 3
# tiles (1x8x24) and 12 (2x16x24: two images, a non-square tile grid)
GDFN_BWD_CASES = [(c, hid, b, h) for c, hid, _ in GDFN_WIDTHS for b, h in ((1, 8), (2, 16))]


@pytest.mark.cuda
@pytest.mark.parametrize("c,hid,b,h", GDFN_BWD_CASES)
def test_cuda_gdfn_bwd_tiles_match_plain(c, hid, b, h, monkeypatch):
    """The GDFN backward on the card against gdfn_bwd_plain, every output,
    with and without the residual: bf16 (the two tiles, wgrad, the part sums)
    within 3e-2 and float32 (mp_gdfn_bwd + dwconv_bwd + ln_linear_bwd, SIMT)
    within 1e-4 of each output's max-abs. One counted launch per call; the
    bf16 route launches tile 1 and tile 2 and no dwconv_bwd or ln_linear_bwd;
    two bf16 calls give bitwise the same outputs (no float atomics). Both
    tiles' plans within the device's limit, each its mirror's dynamic bytes
    plus the static; the float32 plan as it was."""
    from mp_hsir_tpu_torch.ops.kernels import _build, gdfn as gd

    dev = _cuda()
    args, _ = _gdfn_inputs(c, hid, 0, False, b, h, 24, dev)
    dy = _t(_n(_rng(170 + c + b), (b, h, 24, c))).to(dev)
    calls = []
    for name in ("dwconv_bwd", "ln_linear_bwd"):
        fn = getattr(gd, name)
        monkeypatch.setattr(gd, name,
                            lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    get = gd._entry

    def counted(kind="fwd"):
        fn = get(kind)
        return lambda *a: calls.append(fn.__name__) or fn(*a)

    monkeypatch.setattr(gd, "_entry", counted)
    for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
        bf16 = dt == torch.bfloat16
        for residual in (False, True):
            call = (args[0].to(dt), *args[1:], residual, 1e-5, dy.to(dt))
            what = f"{dt} residual={residual}"
            _route.reset_counters()
            calls.clear()
            got = gd._bwd_launch(*call)
            assert _route.COUNTERS["gdfn_bwd"].launches == 1, what
            want = (["mp_gdfn_bwd_tc", "mp_gdfn_dx_tc"] if bf16 else
                    ["mp_gdfn_bwd", "dwconv_bwd", "ln_linear_bwd"])
            assert calls == want, (what, calls)
            _outputs_close(got, gd.gdfn_bwd_plain(*call), tol, what)
            if bf16:
                again = gd._bwd_launch(*call)
                assert all(torch.equal(a, r) for a, r in zip(got, again)), what
    pl, limit = gd.gdfn_bwd_tc_plan(c, hid), _build.smem_limit()
    n1 = _build.plan_bytes("mp_gdfn_bwd_tc_smem", c)
    n2 = _build.plan_bytes("mp_gdfn_dx_tc_smem", c)
    assert pl["bytes"] < n1 <= min(pl["bytes"] + 1024, limit), n1
    assert pl["dx"]["bytes"] < n2 <= min(pl["dx"]["bytes"] + 1024, limit), n2
    kc = _build.chunk("mp_gdfn_bwd_chunk", c)
    assert _build.plan_bytes("mp_gdfn_bwd_smem", c, kc) == GDFN_BWD_PLANS[c]


@pytest.mark.cuda
def test_cuda_gdfn_bwd_bf16_past_384_raises():
    """The bf16 GDFN backward takes C up to 384 and raises above it (no
    fallback); float32 streams its input in chunks and runs."""
    from mp_hsir_tpu_torch.ops.kernels import gdfn as gd

    dev = _cuda()
    args, _ = _gdfn_inputs(400, 1064, 0, False, 1, 8, 8, dev)
    dy = _t(_n(_rng(171), (1, 8, 8, 400))).to(dev)
    with pytest.raises(ValueError, match="C up to 384"):
        gd._bwd_launch(args[0].to(torch.bfloat16), *args[1:], True, 1e-5, dy.to(torch.bfloat16))
    call = (*args, True, 1e-5, dy)
    _outputs_close(gd._bwd_launch(*call), gd.gdfn_bwd_plain(*call), 1e-4, "float32")


# The bf16 window-attention backward (K8): window_attention_bwd_tc_kernel
# (tile 1) and dwconv_dx_tc_kernel without its stencil (tile 2) at every
# (C, heads) of both presets' train steps (dh 32, 64, 48, 96) and C = 36 and
# 27 (dh 18 and 9, padded to 32 and 16; 3C = 108 and 81: element-wise copies
# and a ragged last chunk), on 3 windows (1x8x24) and 12 (2x16x24: two
# images, a non-square window grid)
WINDOW_BWD_WIDTHS = ((64, 2), (128, 4), (256, 8), (128, 2), (96, 2), (192, 4), (384, 8),
                     (192, 2), (36, 2), (27, 3))
WINDOW_BWD_CASES = [(c, heads, b, h) for c, heads in WINDOW_BWD_WIDTHS
                    for b, h in ((1, 8), (2, 16))]


def _window_bwd_inputs(c, heads, b, h, w, dev):
    """(forward operands in the torch layouts, (dout, dpool)), float32."""
    r = _rng(150 + c + heads + b)
    f = lambda *s, scale=1.0: _t(_n(r, s, scale)).to(dev)  # noqa: E731
    return ((f(b, h, w, c), 1 + f(c, scale=0.1), f(c, scale=0.1), f(3 * c, c, scale=c ** -0.5),
             f(3 * c, scale=0.1), f(heads, 64, 64, scale=0.02), f(c, c, scale=c ** -0.5),
             f(c, scale=0.1)), (f(b, h, w, c), f(b, h // 8, w // 8, c)))


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,b,h", WINDOW_BWD_CASES)
def test_cuda_window_attention_bwd_tiles_match_plain(c, heads, b, h, monkeypatch):
    """The window-attention backward on the card against
    window_attention_bwd_plain, every output, unshifted and shifted: bf16 (the
    two tiles, two wgrads, one sum_parts) within 3e-2 and float32
    (mp_window_attention_bwd + ln_linear_bwd, SIMT) within 1e-4 of each
    output's max-abs (the bounds of test_cuda_remote_sensing_backward_matches_
    plain). One counted launch per call; the bf16 route launches each tile
    once and no mp_window_attention_bwd or ln_linear_bwd; two bf16 calls give
    bitwise the same outputs (no float atomics). Both tiles' plans within the
    device's limit, each at least its mirror's dynamic bytes and at most 1 KB
    of static more."""
    from mp_hsir_tpu_torch.ops.kernels import _build, window_attention as wa

    dev = _cuda()
    fwd, (dout, dpool) = _window_bwd_inputs(c, heads, b, h, 24, dev)
    calls = []
    fn = wa.ln_linear_bwd
    monkeypatch.setattr(wa, "ln_linear_bwd",
                        lambda *a, **k: calls.append("ln_linear_bwd") or fn(*a, **k))
    get = wa._entry

    def counted(kind="fwd"):
        entry = get(kind)
        return lambda *a: calls.append(entry.__name__) or entry(*a)

    monkeypatch.setattr(wa, "_entry", counted)
    for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
        bf16 = dt == torch.bfloat16
        for shift in (0, 4):
            call = (fwd[0].to(dt), *fwd[1:], heads, shift, 1e-5, dout.to(dt), dpool.to(dt))
            what = f"{dt} shift={shift}"
            _route.reset_counters()
            calls.clear()
            got = wa._bwd_launch(*call)
            assert _route.COUNTERS["window_attention_bwd"].launches == 1, what
            assert calls == (["mp_window_attention_bwd_tc", "mp_window_attention_dx_tc"] if bf16
                             else ["mp_window_attention_bwd", "ln_linear_bwd"]), (what, calls)
            _outputs_close(got, wa.window_attention_bwd_plain(*call), tol, what)
            if bf16:
                again = wa._bwd_launch(*call)
                assert all(torch.equal(a, r) for a, r in zip(got, again)), what
    pl, limit = wa.window_bwd_tc_plan(c, heads), _build.smem_limit()
    n1 = _build.plan_bytes("mp_window_attention_bwd_tc_smem", c, heads)
    n2 = _build.plan_bytes("mp_window_attention_dx_tc_smem", c)
    assert pl["bytes"] <= n1 <= min(pl["bytes"] + 1024, limit), n1
    assert pl["dx"]["bytes"] <= n2 <= min(pl["dx"]["bytes"] + 1024, limit), n2


@pytest.mark.cuda
def test_cuda_window_attention_bwd_bf16_past_384_raises():
    """The bf16 window backward takes C up to 384 and raises above it (no
    fallback); float32 runs its SIMT kernel."""
    from mp_hsir_tpu_torch.ops.kernels import window_attention as wa

    dev = _cuda()
    fwd, (dout, dpool) = _window_bwd_inputs(400, 8, 1, 8, 8, dev)
    with pytest.raises(ValueError, match="C up to 384"):
        wa._bwd_launch(fwd[0].to(torch.bfloat16), *fwd[1:], 8, 0, 1e-5,
                       dout.to(torch.bfloat16), dpool.to(torch.bfloat16))
    call = (*fwd, 8, 0, 1e-5, dout, dpool)
    _outputs_close(wa._bwd_launch(*call), wa.window_attention_bwd_plain(*call), 1e-4, "float32")


# The weight product (csrc/grad.cu): bf16 on the tensor cores
# (wgrad_tc_kernel), float32 on the SIMT kernel, at the presets' widths whose
# rows are not whole 16-byte vectors (hid 170 and 340: 4- and 8-byte copies;
# 255 and 1021: element loads; 2 hid 510 and 2042: 4-byte copies) beside C =
# 64, 96, 384, and at C = 36 and 27 (3C = 108, 81); P not a multiple of the
# ring depth (128 pixels), two images in some; (32, 256, 384, 384) is the
# remote-sensing latent's dcomb, whose single part writes out directly.
WGRAD_CASES = [(1, 2248, 64, 340), (1, 2248, 170, 64), (2, 2248, 255, 96), (1, 2248, 96, 510),
               (1, 2248, 1021, 384), (1, 1100, 384, 2042), (2, 1100, 36, 108),
               (1, 1100, 27, 81), (32, 256, 384, 384)]
WGRAD_TOL = 1e-4  # as chip_smoke.py: float32 sums of the same products in another order


def _wgrad_inputs(nb, p, m, n, dev):
    r = _rng(170 + m + n + nb)
    return _t(_n(r, (nb, p, m))).to(dev), _t(_n(r, (nb, p, n))).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("nb,p,m,n", WGRAD_CASES)
def test_cuda_wgrad_matches_plain(nb, p, m, n):
    """wgrad on the card against wgrad_plain (TF32 off), bf16 and float32,
    3-D and (nb = 1) 2-D operands, within 1e-4 of the plain product's
    max-abs; one counted launch per call; two calls bitwise equal (the parts
    are summed in a fixed order)."""
    from mp_hsir_tpu_torch.ops.kernels._grad import wgrad, wgrad_plain, wgrad_plan

    dev = _cuda()
    a32, b32 = _wgrad_inputs(nb, p, m, n, dev)
    if (nb, p) == (32, 256):
        assert wgrad_plan(nb, p, m, n)[0] == 1
    for dt in (torch.bfloat16, torch.float32):
        a, b = a32.to(dt), b32.to(dt)
        if nb == 1:
            a, b = a[0], b[0]
        _route.reset_counters()
        got = wgrad(a, b)
        assert _route.COUNTERS["wgrad"].launches == 1, dt
        ref = wgrad_plain(a, b)
        _outputs_close((got,), (ref,), WGRAD_TOL, f"{dt}")
        assert torch.equal(got, wgrad(a, b)), dt


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(64, 340), (255, 96)])
def test_cuda_wgrad_unaligned_base_matches_plain(m, n):
    """Operands that start 2 bytes past an aligned address (views from
    element 1 of a buffer): the kernel takes the widest copy the base allows
    (element loads here) and still agrees with wgrad_plain."""
    from mp_hsir_tpu_torch.ops.kernels._grad import wgrad, wgrad_plain

    dev = _cuda()
    p = 1100
    a32, b32 = _wgrad_inputs(1, p, m, n, dev)
    bufs = [torch.zeros(1 + p * w, dtype=torch.bfloat16, device=dev) for w in (m, n)]
    a, b = (buf[1:].view(p, w) for buf, w in zip(bufs, (m, n)))
    a.copy_(a32[0])
    b.copy_(b32[0])
    assert a.data_ptr() % 16 == 2 and a.is_contiguous()
    _outputs_close((wgrad(a, b),), (wgrad_plain(a, b),), WGRAD_TOL, "unaligned")


@pytest.mark.cuda
def test_cuda_wgrad_plain_reference_runs_plain():
    """Inside plain_reference a CUDA tensor takes wgrad_plain: no launch, one
    plain call counted."""
    from mp_hsir_tpu_torch.ops.kernels._grad import wgrad, wgrad_plain

    dev = _cuda()
    a, b = (t[0].to(torch.bfloat16) for t in _wgrad_inputs(1, 300, 64, 96, dev))
    _route.reset_counters()
    with _route.plain_reference():
        out = wgrad(a, b)
    assert _route.COUNTERS["wgrad"].launches == 0 and _route.ROUTE.plain_cuda_calls == 1
    assert torch.equal(out, wgrad_plain(a, b))
