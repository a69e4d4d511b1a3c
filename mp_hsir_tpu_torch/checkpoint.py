"""Parameter bridge between the JAX package's flat params and this
package's state_dict, both ways.

The JAX params are a flax tree; flattened with '/'-joined paths (as
``mp_hsir_tpu/training/checkpoint.py:save_params_npz`` writes
``assets/trained/*.npz``) every key maps to the state_dict key with '.' for
'/'. Layouts convert mechanically:

* 2-D ``weight`` (flax Linear, (in, out)) -> torch Linear (out, in);
* 4-D ``weight`` (HWIO conv) -> OIHW;
* everything else (biases, LayerNorms, ``relative_position_bias_table``
  (225, nH) — gathered by ``SpatialAttention.rel_bias`` through the
  relative-position index —, ``temperature``, ``prompt_param``,
  ``visual_prompt`` (S, S, d), ``text_prompt_learnable`` (T, d)) is kept.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch


def _convert(key: str, value) -> torch.Tensor:
    a = np.asarray(value, dtype=np.float32)
    if key.rsplit("/", 1)[-1] == "weight":
        if a.ndim == 2:
            a = a.T
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
    return torch.tensor(np.ascontiguousarray(a))


def params_from_jax(flat: Mapping[str, np.ndarray],
                    expected: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
    """Flat '/'-keyed JAX params -> state_dict. With ``expected`` (a model's
    state_dict) it raises on any missing or extra key and on any shape
    mismatch."""
    return _checked({k.replace("/", "."): _convert(k, v) for k, v in flat.items()}, expected)


def _checked(sd: dict, expected: Optional[Mapping[str, torch.Tensor]]) -> dict:
    """``sd``, after raising on any key missing from or extra to ``expected``
    and on any shape mismatch (no check without ``expected``)."""
    if expected is not None:
        missing = sorted(set(expected) - set(sd))
        extra = sorted(set(sd) - set(expected))
        if missing or extra:
            raise KeyError(f"params mismatch: {len(missing)} missing {missing[:4]}, "
                           f"{len(extra)} extra {extra[:4]}")
        bad = [(k, tuple(sd[k].shape), tuple(expected[k].shape)) for k in sd
               if sd[k].shape != expected[k].shape]
        if bad:
            raise ValueError(f"params shape mismatch: {bad[:4]}")
    return sd


def load_params_npz(path: str, model: Optional[torch.nn.Module] = None) -> dict:
    """Read a flat-npz params artifact into a state_dict; with ``model``,
    check it against the model's keys and load it (strict)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    sd = params_from_jax(flat, None if model is None else model.state_dict())
    if model is not None:
        model.load_state_dict(sd, strict=True)
    return sd


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """state_dict -> flat '/'-keyed numpy params in the JAX layouts: the
    inverse of :func:`params_from_jax`."""
    flat = {}
    for k, v in state_dict.items():
        a = v.detach().float().cpu().numpy()
        if k.rsplit(".", 1)[-1] == "weight":
            if a.ndim == 2:
                a = a.T
            elif a.ndim == 4:
                a = a.transpose(2, 3, 1, 0)
        flat[k.replace(".", "/")] = np.ascontiguousarray(a)
    return flat


def save_params_npz(path: str, model: torch.nn.Module, dtype=np.float16) -> None:
    """Write a model's parameters as the flat npz artifact the JAX package
    writes and reads (``mp_hsir_tpu/training/checkpoint.py:save_params_npz``,
    float16 by default), so port-trained weights load into either package."""
    flat = params_to_jax(model.state_dict())
    np.savez_compressed(path, **{k: v.astype(dtype) for k, v in flat.items()})


# ---------------------------------------------------------------------------
# the degradation classifier (models/classifier.py): flax variables, that is
# ``params`` and ``batch_stats``, <-> its state_dict. Each flax BatchNorm sits
# one level down, as ``params/<name>/bn/{scale, bias}`` and
# ``batch_stats/<name>/bn/{mean, var}``; the port's ``_BN`` holds them as
# ``<name>.{weight, bias, running_mean, running_var}``. Conv and Linear
# weights convert as the net's do.
# ---------------------------------------------------------------------------

_BN_LEAVES = {("params", "scale"): "weight", ("params", "bias"): "bias",
              ("batch_stats", "mean"): "running_mean", ("batch_stats", "var"): "running_var"}


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    """Nested mapping -> flat '/'-keyed one (flat keys pass through)."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def classifier_params_from_jax(variables: Mapping,
                               expected: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
    """flax ``{"params": ..., "batch_stats": ...}`` of ``FFCResNet`` (nested,
    or flat with '/'-joined keys under the two collections) -> the port
    classifier's state_dict; with ``expected``, checked as
    :func:`params_from_jax` checks."""
    sd = {}
    for key, value in _flatten(variables).items():
        coll, *path = key.split("/")
        if len(path) >= 2 and path[-2] == "bn" and (coll, path[-1]) in _BN_LEAVES:
            path = path[:-2] + [_BN_LEAVES[(coll, path[-1])]]
        elif coll != "params":
            raise KeyError(f"unexpected classifier variable {key}")
        sd[".".join(path)] = _convert("/".join(path), value)
    return _checked(sd, expected)


def classifier_params_to_jax(model: torch.nn.Module) -> dict:
    """The classifier's state_dict as flat '/'-keyed numpy flax variables
    (``params/...``, ``batch_stats/...``): the inverse of
    :func:`classifier_params_from_jax`."""
    from mp_hsir_tpu_torch.models.classifier import _BN

    flat = {}
    bn = {"weight": ("params", "scale"), "bias": ("params", "bias"),
          "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}
    for key, v in model.state_dict().items():
        *path, leaf = key.split(".")
        owner = model.get_submodule(".".join(path))
        a = v.detach().float().cpu().numpy()
        if isinstance(owner, _BN):
            coll, leaf = bn[leaf]
            path = path + ["bn"]
        else:
            coll = "params"
            if leaf == "weight":
                a = a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0)
        flat["/".join([coll, *path, leaf])] = np.ascontiguousarray(a)
    return flat


def save_classifier_npz(path: str, model: torch.nn.Module) -> None:
    """The classifier's variables as a flat npz (float32, flax layouts)."""
    np.savez_compressed(path, **classifier_params_to_jax(model))


def load_classifier_npz(path: str, model: torch.nn.Module) -> None:
    """Load a flat npz written by :func:`save_classifier_npz` (or flax
    variables flattened the same way) into ``model``, strictly."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    model.load_state_dict(classifier_params_from_jax(flat, model.state_dict()), strict=True)
