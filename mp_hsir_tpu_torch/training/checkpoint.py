"""Checkpoints of training (counterpart of
``mp_hsir_tpu/training/checkpoint.py``):

* the train state (model, optimizer, ``step`` and ``updates``) saved and
  restored in this package's own format, ``ckpt_dir/step_<n>/train_state.pt``
  (``torch.save``; the JAX package's Orbax directories are a JAX library's);
* the params-only artifact: the flat npz that both packages read
  (``mp_hsir_tpu_torch/checkpoint.py:save_params_npz``);
* the reference's PyTorch-Lightning ``.ckpt`` (or a bare ``.pt`` / ``.pth``
  state_dict) loaded with its shape-filtered partial load (reference
  train.py:109-116: keep every tensor whose name and shape match, skip the
  rest; test.py:575 strict=False). The key mapping and layout changes are
  copies of the JAX package's, on plain dicts of the JAX layout, which
  ``params_from_jax`` then turns into this package's state_dict:

  * conv weights OIHW -> HWIO, linear weights (out, in) -> (in, out)
  * ``visual_prompt`` (1, D, ps, ps) -> (ps, ps, D)
  * ``text_prompt_learnable`` (1, T, D, 1, 1) -> (T, D)
  * Restormer LayerNorm ``*.body.weight`` -> ``*.weight``
  * ``blocks.N.*`` module lists -> ``blocks_N.*``
  * buffers (attn_mask, relative_position_index) are recomputed, not loaded
"""

from __future__ import annotations

import os
import re
import shutil
import warnings
from typing import Dict, Tuple

import numpy as np
import torch

from mp_hsir_tpu_torch.checkpoint import params_from_jax, params_to_jax, save_params_npz
from mp_hsir_tpu_torch.models.text_prompts import _placeholder_table, clip_text_table

STATE_FILE = "train_state.pt"

# ---------------------------------------------------------------------------
# the train state
# ---------------------------------------------------------------------------


def save_checkpoint(ckpt_dir: str, state, step: int, keep: int = 0) -> str:
    """Save model, optimizer, step and updates; returns the directory. With
    keep > 0 only the newest ``keep`` step_* checkpoints stay."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "step": state.step, "updates": state.updates, "last_lr": state.last_lr},
               os.path.join(path, STATE_FILE))
    if keep > 0:
        steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
        for old in steps[:-keep]:
            shutil.rmtree(os.path.join(ckpt_dir, old), ignore_errors=True)
    return path


def restore_checkpoint(path: str, state):
    """Full resume into ``state`` (its model and optimizer, in place). The
    blob is read to the host: the optimizer moves its moments to the
    parameters' device and keeps its step counts on the host, where a
    non-capturable AdamW reads them without a device sync."""
    blob = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    state.model.load_state_dict(blob["model"], strict=True)
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step, state.updates, state.last_lr = blob["step"], blob["updates"], blob["last_lr"]
    return state


def save_params(path: str, model: torch.nn.Module) -> None:
    """Params-only artifact (eval and distribution): the flat float16 npz."""
    save_params_npz(path, model)


# ---------------------------------------------------------------------------
# reference Lightning checkpoints
# ---------------------------------------------------------------------------


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a Lightning .ckpt (or bare state_dict .pt/.pth) into numpy,
    stripping the Lightning ``net.`` / ``model.`` prefixes."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    out = {}
    for k, v in sd.items():
        if not hasattr(v, "numpy"):
            continue
        out[re.sub(r"^(net\.|model\.)", "", k)] = v.detach().float().numpy()
    return out


_SKIP_PATTERNS = (
    re.compile(r"attn_mask$"),
    re.compile(r"relative_position_index$"),
    re.compile(r"(text_linear|clip_linear)\.(weight|bias)$"),  # unused at runtime
)


def _torch_key_to_path(key: str) -> Tuple[str, ...]:
    """Map a reference torch dotted name onto the JAX param path."""
    key = key.replace(".body.weight", ".weight").replace(".body.bias", ".bias")
    key = re.sub(r"\bblocks\.(\d+)\.", r"blocks_\1.", key)
    key = re.sub(r"\b(down1_2|down2_3|up3_2|up2_1)\.body\.0\.", r"\1.conv.", key)
    return tuple(key.split("."))


def _adapt(value: np.ndarray, target: np.ndarray, path: Tuple[str, ...]):
    """A reference tensor in the target's JAX layout, or None where the shapes
    cannot agree (then the target is kept: the reference's shape filter)."""
    leaf = path[-1]
    if (len(path) >= 2 and path[-2] == "visual_prompt") or leaf == "visual_prompt":
        v = np.transpose(value[0], (1, 2, 0))  # (D,ps,ps) -> (ps,ps,D)
        return v if v.shape == target.shape else None
    if leaf == "text_prompt_learnable" or (len(path) >= 2 and path[-2] == "text_prompt_learnable"):
        v = value.reshape(value.shape[1], value.shape[2])
        return v if v.shape == target.shape else None
    if leaf == "weight" and value.ndim == 2:
        # torch Linear weights are always (out, in): transpose even when square
        v = value.T
        return v if v.shape == target.shape else None
    if leaf == "weight" and value.ndim == 4:
        v = np.transpose(value, (2, 3, 1, 0))  # conv OIHW -> HWIO
        return v if v.shape == target.shape else None
    if value.shape == target.shape:
        return value
    return None


def convert_torch_state(torch_state: Dict[str, np.ndarray], target: Dict[str, np.ndarray]
                        ) -> Tuple[Dict[str, np.ndarray], Dict[str, list]]:
    """Merge a reference state_dict into flat '/'-keyed params in the JAX
    layout (``params_to_jax`` of a model). Returns (params, report); the
    report lists loaded, shape-skipped and unmatched reference keys."""
    flat = {tuple(k.split("/")): np.asarray(v) for k, v in target.items()}
    loaded, shape_skipped, unmatched = [], [], []
    for k, v in torch_state.items():
        if any(p.search(k) for p in _SKIP_PATTERNS):
            continue
        path = _torch_key_to_path(k)
        if path not in flat:
            unmatched.append(k)
            continue
        adapted = _adapt(v, flat[path], path)
        if adapted is None:
            shape_skipped.append(k)
            continue
        flat[path] = np.asarray(adapted, dtype=flat[path].dtype)
        loaded.append(k)
    report = {"loaded": loaded, "shape_skipped": shape_skipped, "unmatched": unmatched}
    return {"/".join(p): v for p, v in flat.items()}, report


def _warn_if_placeholder_clip_table(task_classes: int) -> bool:
    """Warn when reference weights will run against the seeded placeholder
    CLIP table: the prompt pathway then sees other text embeddings than the
    reference's, and quality cannot match the published numbers."""
    if not np.array_equal(clip_text_table(task_classes), _placeholder_table(task_classes)):
        return False
    msg = ("converted reference checkpoint is running with the SEEDED PLACEHOLDER CLIP "
           "text-embedding table — restored PSNR will NOT match the published reference "
           "numbers. Provide the real table (assets/clip_text_embeddings.npz or "
           "MP_HSIR_CLIP_TABLE, see models/text_prompts.py).")
    warnings.warn(msg, RuntimeWarning, stacklevel=3)
    print(f"[ckpt] WARNING: {msg}")
    return True


def load_reference_checkpoint(path: str, model: torch.nn.Module, verbose: bool = True) -> dict:
    """Reference Lightning checkpoint -> ``model`` (in place) with the
    shape-filtered partial load; returns the report."""
    flat, report = convert_torch_state(load_torch_state_dict(path),
                                       params_to_jax(model.state_dict()))
    model.load_state_dict(params_from_jax(flat, model.state_dict()), strict=True)
    if verbose:
        print(f"[ckpt] loaded {len(report['loaded'])} tensors, "
              f"shape-skipped {len(report['shape_skipped'])}, "
              f"unmatched {len(report['unmatched'])}")
    if report["loaded"]:
        _warn_if_placeholder_clip_table(model.cfg.task_classes)
    return report
