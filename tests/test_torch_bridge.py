"""The parameter bridge: every key of the committed flagship npz lands on a
parameter of the port's model, in the port's layout, and nothing is left over."""

import os

import numpy as np
import pytest
import torch

from mp_hsir_tpu_torch.checkpoint import load_params_npz, params_from_jax
from mp_hsir_tpu_torch.config import natural_scene_config
from mp_hsir_tpu_torch.models.mp_hsir import MPHSIRNet
import torch_threads  # noqa: E402,F401  (one compute thread per process)

ART = os.path.join(os.path.dirname(__file__), "..", "assets", "trained", "natural_12k_f16.npz")
needs_art = pytest.mark.skipif(not os.path.exists(ART), reason="trained artifact not committed")


@pytest.fixture(scope="module")
def flat():
    with np.load(ART) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def model():
    return MPHSIRNet(natural_scene_config())


@needs_art
def test_all_617_keys_map_with_no_extra(flat, model):
    expected = model.state_dict()
    assert len(flat) == 617
    assert len(expected) == 617
    sd = params_from_jax(flat, expected)
    assert set(sd) == set(expected)
    assert sum(t.numel() for t in sd.values()) == sum(t.numel() for t in expected.values())
    load_params_npz(ART, model)


@needs_art
@pytest.mark.parametrize("key,torch_key,convert", [
    ("latent/blocks_0/attn/qkv/weight", "latent.blocks_0.attn.qkv.weight", lambda a: a.T),
    ("output/weight", "output.weight", lambda a: a.transpose(3, 2, 0, 1)),
    ("fusion1/transformer/ffn/dwconv/weight", "fusion1.transformer.ffn.dwconv.weight",
     lambda a: a.transpose(3, 2, 0, 1)),
    ("encoder_level1/blocks_1/attn/relative_position_bias_table",
     "encoder_level1.blocks_1.attn.relative_position_bias_table", lambda a: a),
    ("prompt1/visual_prompt", "prompt1.visual_prompt", lambda a: a),
])
def test_layouts_convert(flat, key, torch_key, convert):
    sd = params_from_jax({key: flat[key]})
    np.testing.assert_array_equal(sd[torch_key].numpy(), convert(flat[key].astype(np.float32)))


@needs_art
def test_missing_or_extra_keys_raise(flat, model):
    expected = model.state_dict()
    short = dict(flat)
    short.pop("output/weight")
    with pytest.raises(KeyError, match="1 missing"):
        params_from_jax(short, expected)
    with pytest.raises(KeyError, match="1 extra"):
        params_from_jax({**flat, "output/bias": np.zeros(31, np.float32)}, expected)
    bad = {**flat, "output/weight": np.zeros((3, 3, 128, 30), np.float32)}
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, expected)


def test_relative_position_bias_gathers_like_jax():
    """SpatialAttention.rel_bias equals the JAX module's gather
    table[_relative_position_index].reshape(N, N, nH).transpose(2, 0, 1)."""
    from mp_hsir_tpu.models.layers import _relative_position_index
    from mp_hsir_tpu_torch.models.layers import SpatialAttention

    mod = SpatialAttention(16, 8, 2)
    table = mod.relative_position_bias_table.detach().numpy()
    want = table[_relative_position_index(8).reshape(-1)].reshape(64, 64, 2).transpose(2, 0, 1)
    np.testing.assert_array_equal(mod.rel_bias().detach().numpy(), want)
    assert "relative_position_index" not in mod.state_dict()
    assert isinstance(mod.rel_bias(), torch.Tensor)
