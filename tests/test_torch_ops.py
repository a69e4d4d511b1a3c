"""The PyTorch port's primitives (ops/basic, ops/window, ops/resize,
ops/conv) and configuration against their JAX counterparts, on the CPU in
float32 on the same numpy-seeded inputs.

Tolerance: exact where both sides only move data (shuffles, windows, rolls,
region maps) or compute it in numpy (resize matrices are built the same
way); 1e-5 absolute and relative where float32 arithmetic may sum in another
order (norms, GELU, resizes, convolutions).
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mp_hsir_tpu import config as JC
from mp_hsir_tpu.ops import basic as JB
from mp_hsir_tpu.ops import conv as JCV
from mp_hsir_tpu.ops import resize as JR
from mp_hsir_tpu.ops import window as JW
from mp_hsir_tpu_torch import config as TC
from mp_hsir_tpu_torch.ops import basic as TB
from mp_hsir_tpu_torch.ops import conv as TCV
from mp_hsir_tpu_torch.ops import resize as TR
from mp_hsir_tpu_torch.ops import window as TW
from torch_port_inputs import normal, rng
import torch_threads  # noqa: E402,F401  (one compute thread per process)

TOL = dict(atol=1e-5, rtol=1e-5)


def _x(seed, shape):
    return normal(rng(seed), shape)


@pytest.mark.parametrize("name", ["layer_norm", "layer_norm_biasfree", "gelu_exact"])
def test_norms_and_gelu_match_jax(name):
    r = rng(11)
    x = normal(r, (2, 8, 8, 24), 2.0) + 0.5
    w, b = 1 + normal(r, (24,), 0.1), normal(r, (24,), 0.1)
    args = {"layer_norm": (w, b), "layer_norm_biasfree": (w,), "gelu_exact": ()}[name]
    want = getattr(JB, name)(jnp.asarray(x), *map(jnp.asarray, args))
    got = getattr(TB, name)(torch.from_numpy(x), *map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name,shape", [("pixel_shuffle", (2, 4, 6, 12)),
                                        ("pixel_unshuffle", (2, 8, 6, 3))])
def test_pixel_shuffles_match_jax(name, shape):
    x = _x(12, shape)
    want = getattr(JB, name)(jnp.asarray(x), 2)
    got = getattr(TB, name)(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_window_partition_and_reverse_match_jax():
    x = _x(13, (2, 16, 24, 5))
    want = JW.window_partition(jnp.asarray(x), 8)
    got = TW.window_partition(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = TW.window_reverse(got, 8, 16, 24)
    np.testing.assert_array_equal(back.numpy(), np.asarray(JW.window_reverse(want, 8, 16, 24)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("h,w,shift", [(32, 32, 4), (16, 40, 4), (24, 16, 0)])
def test_shift_region_bookkeeping_matches_jax(h, w, shift):
    for name in ("shifted_region_map", "shifted_window_labels", "shifted_window_mask"):
        np.testing.assert_array_equal(getattr(TW, name)(h, w, 8, shift),
                                      getattr(JW, name)(h, w, 8, shift), err_msg=name)


@pytest.mark.parametrize("sh,sw", [(-4, -4), (4, 4), (3, -5), (0, 2)])
def test_roll_matches_jax(sh, sw):
    x = _x(14, (1, 16, 24, 3))
    np.testing.assert_array_equal(TW.roll_hw(torch.from_numpy(x), sh, sw).numpy(),
                                  np.asarray(JW.roll_hw(jnp.asarray(x), sh, sw)))


@pytest.mark.parametrize("mode,out_hw,align", [("bilinear", (40, 24), False),
                                               ("bilinear", (8, 12), False),
                                               ("bilinear", (40, 24), True),
                                               ("nearest", (32, 32), False),
                                               ("nearest", (10, 6), False)])
def test_resizes_match_jax(mode, out_hw, align):
    x = _x(15, (2, 16, 12, 4))
    if mode == "bilinear":
        want = JR.resize_bilinear(jnp.asarray(x), *out_hw, align_corners=align)
        got = TR.resize_bilinear(torch.from_numpy(x), *out_hw, align_corners=align)
    else:
        want = JR.resize_nearest(jnp.asarray(x), *out_hw)
        got = TR.resize_nearest(torch.from_numpy(x), *out_hw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["dense_1x1_bias", "dense_3x3", "depthwise_3x3"])
def test_convs_match_jax(kind):
    """HWIO on the JAX side, OIHW here; NHWC maps on both."""
    r = rng(16)
    x = normal(r, (2, 12, 16, 6))
    if kind == "depthwise_3x3":
        w = normal(r, (3, 3, 1, 6), 0.3)
        want = JCV.depthwise_conv2d(jnp.asarray(x), jnp.asarray(w))
        got = TCV.depthwise_conv2d(torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    else:
        k = 1 if kind == "dense_1x1_bias" else 3
        w = normal(r, (k, k, 6, 10), 0.3)
        b = normal(r, (10,), 0.1) if k == 1 else None
        want = JCV.conv2d(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
                          padding=k // 2)
        got = TCV.conv2d(torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                         None if b is None else torch.from_numpy(b), padding=k // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("preset", ["natural_scene_config", "remote_sensing_config"])
def test_presets_equal_jax(preset):
    """Every field the port keeps has the JAX preset's value."""
    got = dataclasses.asdict(getattr(TC, preset)())
    want = dataclasses.asdict(getattr(JC, preset)())
    assert {k: want[k] for k in got} == got
    assert getattr(TC, preset)().dims == getattr(JC, preset)().dims


def test_eval_config_mode0_fields_equal_jax():
    got = dataclasses.asdict(TC.EvalConfig())
    want = dataclasses.asdict(JC.EvalConfig())
    assert {k: want[k] for k in got} == got
