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
    sd = {k.replace("/", "."): _convert(k, v) for k, v in flat.items()}
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
