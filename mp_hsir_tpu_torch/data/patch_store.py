"""HSPS — hyperspectral patch store (a copy of
``mp_hsir_tpu/data/patch_store.py``: the same files, byte for byte, so a store
written by either package reads in the other).

Replaces the reference's LMDB patch database (utils/dataset_utils.py:39-100,
utils/lmdb_patch.py) with a memory-mapped packed format:

* ``data.bin``       — raw float32 patch payloads, back to back
* ``meta_info.txt``  — one line per patch, the reference's sidecar contract:
                        ``<idx> (h,w,c) source_file=<name>``
* ``offsets.npy``    — int64 byte offsets (derivable from meta; cached)

Reading is a zero-copy ``np.memmap`` slice; a batch of same-shape patches is
one gather into a host array, which the train pipeline uploads.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

_META_RE = re.compile(r"^(\S+)\s+\((\d+),(\d+),(\d+)\)\s+source_file=(\S+)")

# the reference hard-codes this training-source filter inside the dataset
# class (utils/dataset_utils.py:56); here it is an argument with the same
# default
DEFAULT_DATASET_NAMES = (
    "BerlinUrGrad", "Chikusei", "Eagle", "Xiongan", "Houston", "PaviaC", "PaviaU", "WDC",
)
# natural-scene sources (the commented-out alternative on the same reference
# line — the reference edits the hard-coded list per run)
NATURAL_DATASET_NAMES = ("ARAD", "ICVL")


class PatchStoreWriter:
    def __init__(self, path: str):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self._bin = open(os.path.join(path, "data.bin"), "wb")
        self._meta: List[str] = []
        self._offsets: List[int] = [0]
        self._count = 0

    def add(self, patch: np.ndarray, source_file: str) -> None:
        """patch: (C, H, W) float32. Meta records (H, W, C) like the
        reference's LMDB builder (utils/lmdb_patch.py:107-114)."""
        patch = np.ascontiguousarray(patch, dtype=np.float32)
        c, h, w = patch.shape
        self._bin.write(patch.tobytes())
        self._meta.append(f"{self._count:08d} ({h},{w},{c}) source_file={source_file}")
        self._offsets.append(self._offsets[-1] + patch.nbytes)
        self._count += 1

    def close(self) -> None:
        self._bin.close()
        with open(os.path.join(self.path, "meta_info.txt"), "w") as f:
            f.write("\n".join(self._meta) + ("\n" if self._meta else ""))
        np.save(os.path.join(self.path, "offsets.npy"), np.asarray(self._offsets, np.int64))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PatchStore:
    """Read-only patch store with source-name filtering."""

    def __init__(self, path: str, dataset_names: Optional[Sequence[str]] = DEFAULT_DATASET_NAMES):
        self.path = path
        self.meta: List[Tuple[Tuple[int, int, int], str]] = []
        with open(os.path.join(path, "meta_info.txt")) as f:
            for line in f:
                m = _META_RE.match(line.strip())
                if not m:
                    continue
                h, w, c = int(m.group(2)), int(m.group(3)), int(m.group(4))
                self.meta.append(((h, w, c), m.group(5)))
        off_path = os.path.join(path, "offsets.npy")
        if os.path.exists(off_path):
            self.offsets = np.load(off_path)
        else:
            sizes = np.asarray([h * w * c * 4 for (h, w, c), _ in self.meta], np.int64)
            self.offsets = np.concatenate([[0], np.cumsum(sizes)])
        self._mmap = np.memmap(os.path.join(path, "data.bin"), dtype=np.float32, mode="r")

        if dataset_names:
            self.valid_idx = np.asarray(
                [i for i, (_, src) in enumerate(self.meta) if any(src.startswith(n) for n in dataset_names)],
                np.int64,
            )
            if len(self.valid_idx) == 0 and len(self.meta) > 0:
                # a store whose sources match none of the known prefixes
                # (e.g. custom data): training on 0 patches is never what
                # the caller wants — warn and use everything instead of
                # failing later with an opaque empty-epoch error
                print(f"[patch_store] no sources match {tuple(dataset_names)}; "
                      f"using all {len(self.meta)} patches")
                self.valid_idx = np.arange(len(self.meta), dtype=np.int64)
        else:
            self.valid_idx = np.arange(len(self.meta), dtype=np.int64)

    def __len__(self) -> int:
        return len(self.valid_idx)

    def shape_of(self, i: int) -> Tuple[int, int, int]:
        (h, w, c), _ = self.meta[int(self.valid_idx[i % len(self)])]
        return (c, h, w)

    def source_of(self, i: int) -> str:
        return self.meta[int(self.valid_idx[i % len(self)])][1]

    def __getitem__(self, i: int) -> Tuple[np.ndarray, str]:
        gi = int(self.valid_idx[i % len(self)])
        (h, w, c), src = self.meta[gi]
        start = self.offsets[gi] // 4
        patch = self._mmap[start : start + h * w * c].reshape(c, h, w)
        return patch, src

    def gather(self, idxs: np.ndarray) -> np.ndarray:
        """Batch-gather same-shape patches -> (B, C, H, W) float32 copy."""
        shapes = {self.shape_of(int(i)) for i in idxs}
        if len(shapes) != 1:  # explicit: asserts vanish under python -O
            raise ValueError(f"mixed patch shapes {shapes}")
        c, h, w = shapes.pop()
        out = np.empty((len(idxs), c, h, w), np.float32)
        for j, i in enumerate(idxs):
            out[j] = self[int(i)][0]
        return out
