"""The window MSA kernel's plain version (K14) and the port's
``SpatialAttention.forward`` against the JAX package's Pallas K14
(``fused_window_attention``) in interpret mode, float32 on the CPU; the
kernel's missing backward; the wrappers' shared-memory plan check.

Tolerance 2e-5 absolute, as ``tests/test_pallas_attention.py`` holds the
Pallas kernel to the jnp module: float32 on both sides, sums in other orders.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from mp_hsir_tpu.models.layers import SpatialAttention as JaxSpatialAttention
from mp_hsir_tpu.models.layers import _relative_position_index
from mp_hsir_tpu.ops.pallas_attention import fused_window_attention
from mp_hsir_tpu.ops.window import shifted_window_labels
from mp_hsir_tpu_torch.checkpoint import params_from_jax
from mp_hsir_tpu_torch.models.layers import SpatialAttention
from mp_hsir_tpu_torch.ops.kernels import _build
from mp_hsir_tpu_torch.ops.kernels._route import COUNTERS
from mp_hsir_tpu_torch.ops.kernels.window_msa import window_msa, window_msa_plain
from torch_port_inputs import normal, rng, tensor, uniform
import torch_threads  # noqa: E402,F401  (one compute thread per process)

WS, N = 8, 64


def _labels(masked, h=16, w=16):
    return shifted_window_labels(h, w, WS, WS // 2) if masked else None


@pytest.mark.parametrize("masked", [False, True])
def test_window_msa_plain_matches_pallas(masked):
    """Eight windows: the 4-window label pattern of a 16x16 map tiled twice,
    so the tiling over windows is exercised too."""
    c, heads = 16, 2
    r = rng(40 + masked)
    x = normal(r, (8, N, c))
    wqkv, bqkv = uniform(r, (c, 3 * c), c), uniform(r, (3 * c,), c)
    bias = normal(r, (heads, N, N), 0.02)
    wp, bp = uniform(r, (c, c), c), uniform(r, (c,), c)
    lab = _labels(masked)
    want = np.asarray(fused_window_attention(
        jnp.asarray(x), jnp.asarray(wqkv), jnp.asarray(bqkv), jnp.asarray(bias), jnp.asarray(wp),
        jnp.asarray(bp), None if lab is None else jnp.asarray(lab), heads, block_windows=2,
        interpret=True))
    got = window_msa_plain(tensor(x), tensor(wqkv).t(), tensor(bqkv), tensor(bias),
                           tensor(wp).t(), tensor(bp), heads,
                           None if lab is None else torch.as_tensor(lab))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_spatial_attention_matches_jax_pallas_module(masked, monkeypatch):
    """Port ``SpatialAttention.forward`` (the wrapper on CPU tensors) against
    JAX ``SpatialAttention(use_pallas=True)`` with K14 in interpret mode, the
    same parameters through ``params_from_jax``."""
    import mp_hsir_tpu.ops.pallas_attention as PA

    c, heads = 16, 2
    x = normal(rng(44 + masked), (4, N, c))
    lab = _labels(masked)
    orig = PA.fused_window_attention
    monkeypatch.setattr(PA, "fused_window_attention",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    jm = JaxSpatialAttention(c, WS, heads, use_pallas=True)
    params = jm.init(jax.random.key(3), jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), None,
                               None if lab is None else jnp.asarray(lab)))

    port = SpatialAttention(c, WS, heads)
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    port.load_state_dict(params_from_jax(flat, port.state_dict()))
    before = COUNTERS["window_msa"].launches
    with torch.no_grad():
        got = port(tensor(x), None if lab is None else torch.as_tensor(lab)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert COUNTERS["window_msa"].launches == before  # the CPU runs the plain version

    # the bias gathered from the table as the JAX module gathers it
    table = np.asarray(params["relative_position_bias_table"])
    bias = table[_relative_position_index(WS).reshape(-1)].reshape(N, N, heads).transpose(2, 0, 1)
    np.testing.assert_array_equal(port.rel_bias().detach().numpy(), bias)


@pytest.mark.parametrize("masked", [False, True])
def test_chip_smoke_library_call_matches_plain(masked):
    """The library yardstick chip_smoke.py times beside K14
    (``F.multi_head_attention_forward`` with the bias and label mask as a
    float attn_mask) computes the plain version's function."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    c, heads = 16, 2
    torch.manual_seed(47)
    layer = SpatialAttention(c, WS, heads).eval()
    x = tensor(normal(rng(47 + masked), (8, N, c)))
    lab = None if not masked else torch.as_tensor(_labels(masked))
    with torch.no_grad():
        want = window_msa_plain(x, layer.qkv.weight, layer.qkv.bias, layer.rel_bias(),
                                layer.proj.weight, layer.proj.bias, heads, lab)
    got = smoke.k14_library(layer, x, lab)()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


def test_window_msa_backward_raises():
    c, heads = 16, 2
    r = rng(46)
    x = tensor(normal(r, (2, N, c))).requires_grad_(True)
    w = [tensor(uniform(r, s, c)) for s in ((3 * c, c), (3 * c,), (c, c), (c,))]
    out = window_msa(x, w[0], w[1], tensor(normal(r, (heads, N, N), 0.02)), w[2], w[3], heads)
    with pytest.raises(RuntimeError, match="no backward"):
        out.sum().backward()


def test_plan_check_names_kernel_shape_and_bytes(monkeypatch):
    """A plan over the device's opt-in limit raises a readable ValueError
    before any launch (the limit and the plan stand in for the card's)."""
    monkeypatch.setattr(_build, "smem_limit", lambda: 232448)
    monkeypatch.setattr(_build, "plan_bytes", lambda entry, *shape: 250880 if shape[0] == 384 else 1024)
    assert _build.check_plan("window_attention", "mp_window_attention_smem", "C=64", 64, 2, 64) == 1024
    with pytest.raises(ValueError, match=r"window_attention at C=384, heads=8: .*250880 bytes.*232448"):
        _build.check_plan("window_attention", "mp_window_attention_smem", "C=384, heads=8", 384, 8,
                          384)
