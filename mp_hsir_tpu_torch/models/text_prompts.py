"""Frozen text-prompt embedding table (copy of
``mp_hsir_tpu/models/text_prompts.py``: same seeded placeholder, same
``MP_HSIR_CLIP_TABLE`` override and the same asset lookup, so both packages
feed the prompt pathway identical numbers)."""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from mp_hsir_tpu_torch import upload

_ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                      "assets", "clip_text_embeddings.npz")

CLIP_EMBED_DIM = 512


def _placeholder_table(n: int, dim: int = CLIP_EMBED_DIM) -> np.ndarray:
    """Seeded stand-in for CLIP ViT-B/32 text embeddings (L2 norm 9.5)."""
    rng = np.random.default_rng(20240 + n)
    t = rng.standard_normal((n, dim)).astype(np.float32)
    t *= 9.5 / np.linalg.norm(t, axis=1, keepdims=True)
    return t


@lru_cache(maxsize=None)
def clip_text_table(task_classes: int) -> np.ndarray:
    """(task_classes, 512) float32 table. Resolution order:
    MP_HSIR_CLIP_TABLE (npz path) > assets/clip_text_embeddings.npz >
    seeded placeholder."""
    if task_classes not in (1, 6, 7):
        raise ValueError("task_classes must be 1, 6 or 7")
    for source in (os.environ.get("MP_HSIR_CLIP_TABLE", ""), _ASSET):
        if source and os.path.exists(source):
            data = np.load(source)
            key = f"table_{task_classes}"
            if key in data:
                return np.asarray(data[key], dtype=np.float32)
    return _placeholder_table(task_classes)


def text_prompt_weights(task_id: torch.Tensor, task_classes: int) -> torch.Tensor:
    """(B,) integer ids or (B, k) mixed ids -> (B, T) float32 weights (the
    one-hots of mixed ids are averaged, reference net/MP_HSIR.py:517-525).
    Out-of-range ids raise (torch indexing), unlike the JAX gather."""
    task_id = torch.as_tensor(task_id)
    if task_id.ndim == 0:
        task_id = task_id[None]
    eye = torch.eye(task_classes, dtype=torch.float32, device=task_id.device)
    onehot = eye[task_id.long()]
    if onehot.ndim == 3:
        onehot = onehot.mean(dim=1)
    return onehot


@lru_cache(maxsize=None)
def _device_table(task_classes: int, device: torch.device) -> torch.Tensor:
    return upload(clip_text_table(task_classes), device)


def clip_prompt_embedding(prompt_weights: torch.Tensor, task_classes: int) -> torch.Tensor:
    """(B, T) weights -> (B, 512) embedding, averaged over the task axis
    (reference net/MP_HSIR.py:529-530). The table is copied to each device
    once, without a synchronising copy."""
    return (prompt_weights @ _device_table(task_classes, prompt_weights.device)) / task_classes
