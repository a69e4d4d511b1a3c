"""Host -> device training data flow (counterpart of
``mp_hsir_tpu/data/train_pipeline.py``; reference train.py:106 and
utils/dataset_utils.py:102-146).

  PatchStore (mmap) --gather--> host batch of CLEAN patches (pinned)
      --non-blocking copy on a side stream (producer thread)--> device
      --> batched degrade + augment on the device (ops/pipeline_degrade)
      --> train step

Only clean patches cross the link. The patch order of epoch e is
``default_rng([seed, e]).permutation``, the task ids of step s
``default_rng([seed, e, s]).integers``, as in the JAX package; every other
discrete choice comes from ``default_rng([seed, e, s, 1])`` and the dense
device draws from a ``torch.Generator`` seeded with ``hash((seed, e, s)) &
0x7FFFFFFF`` (the integer that keys the JAX package's device draws). The
stream is reproducible whatever the thread scheduling.

Overlap: the producer thread gathers, shrinks and pins the batch and issues
its copy on a side stream, ``prefetch`` batches ahead; the consumer's stream
waits on the copy's event before it reads the batch, and ``record_stream``
keeps the batch's memory from the side stream's next allocations until the
consumer's work is done. ``upload_dtype`` shrinks the patches on the host:
``float16`` / ``bfloat16`` (cast with torch: numpy has no bfloat16) widen
back to float32 on the device; ``uint16`` is fixed point (x * 65535, round),
carried in int16's bits and widened through int32.

Resident bank (``resident=True``): the store (or its first ``bank_patches``
patches) is uploaded once in the upload dtype and each batch is gathered on
the device; ``refresh_per_step`` fresh patches per step are streamed into
bank slots round-robin by a producer thread. With the bank covering the store
and refresh off, the batches equal the streaming path's.

On the card each step records CUDA events around its upload and its degrade
(``timings``), read after the run.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional

import numpy as np
import torch

from mp_hsir_tpu_torch import resolve_device, upload
from mp_hsir_tpu_torch.config import TrainConfig
from mp_hsir_tpu_torch.data.patch_store import PatchStore
from mp_hsir_tpu_torch.ops.pipeline_degrade import make_batch_degrader
from mp_hsir_tpu_torch.utils.image import interpolate_bands

UPLOAD_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                 "bfloat16": torch.bfloat16, "uint16": torch.int16}


def _host_shrink(clean: np.ndarray, dtype: str, pin: bool = False) -> torch.Tensor:
    """A float32 [0, 1] host batch as a CPU tensor of the upload dtype
    (uint16 fixed point in int16's bits), in pinned memory if ``pin``."""
    if dtype == "uint16":
        clean = (np.clip(clean, 0.0, 1.0) * 65535.0 + 0.5).astype(np.uint16).view(np.int16)
    src = torch.from_numpy(clean)
    if not pin and src.dtype == UPLOAD_DTYPES[dtype]:
        return src
    out = torch.empty(src.shape, dtype=UPLOAD_DTYPES[dtype], pin_memory=pin)
    return out.copy_(src)


def _dev_widen(clean: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_host_shrink`, on the device: float32."""
    if clean.dtype == torch.int16:
        return (clean.to(torch.int32) & 0xFFFF).float() * np.float32(1.0 / 65535.0)
    return clean.float()


def _put(q: queue.Queue, item, stop: threading.Event) -> None:
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return
        except queue.Full:
            continue


class TrainPipeline:
    def __init__(
        self,
        store: PatchStore,
        tc: TrainConfig,
        cirrus_bank: Optional[np.ndarray] = None,
        target_bands: Optional[int] = None,
        prefetch: int = 2,
        upload_dtype: str = "float32",
        resident: bool = False,
        bank_patches: Optional[int] = None,
        refresh_per_step: int = 0,
        device: str | torch.device = "cuda",
    ):
        if upload_dtype not in UPLOAD_DTYPES:
            raise ValueError(f"upload_dtype must be one of {sorted(UPLOAD_DTYPES)}")
        self.store = store
        self.tc = tc
        self.de_types = tc.de_types_resolved()
        self.target_bands = target_bands
        self.degrader = make_batch_degrader(self.de_types, tc.data_type, cirrus_bank)
        self.upload_dtype = upload_dtype
        self.prefetch = prefetch
        self.resident = resident
        self.bank_patches = bank_patches
        self.refresh_per_step = refresh_per_step
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._bank: Optional[torch.Tensor] = None  # (N, C, H, W) upload dtype
        self._next_store_idx = 0  # next store patch for the refresh rotation
        # per step on the card: (upload start, upload end, degrade start,
        # degrade end) CUDA events; the upload pair is None where nothing
        # was uploaded for the step
        self.timings: List[tuple] = []

    def _host_batch(self, idxs: np.ndarray) -> np.ndarray:
        batch = self.store.gather(idxs)
        if self.target_bands and batch.shape[1] != self.target_bands:
            batch = np.stack([interpolate_bands(b, self.target_bands) for b in batch])
        return batch

    def _upload(self, tensors):
        """Host tensors -> device on the side stream: (device tensors, (start,
        end) events); the consumer waits on ``end``."""
        if not self.cuda:
            return [t.to(self.device) for t in tensors], None
        with torch.cuda.stream(self._stream):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            dev = [t.to(self.device, non_blocking=True) for t in tensors]
            t1.record()
        return dev, (t0, t1)

    def _acquire(self, dev, events) -> None:
        """Make the current stream wait for an upload and own its memory."""
        if events is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(events[1])
        for t in dev:
            t.record_stream(cur)

    def _step_draws(self, epoch_idx: int, s: int, bs: int):
        """Host draws of step s: (int64 [de_ids | order | modes], runs)."""
        de_ids = np.random.default_rng([self.tc.seed, epoch_idx, s]).integers(
            0, len(self.de_types), size=bs)
        rng = np.random.default_rng([self.tc.seed, epoch_idx, s, 1])
        _, modes, order, runs = self.degrader.host_draws(rng, de_ids)
        return np.concatenate([de_ids, order, modes]).astype(np.int64), runs

    def _degrade(self, epoch_idx: int, s: int, clean_dev: torch.Tensor, ints: torch.Tensor,
                 runs, up_events) -> dict:
        bs = clean_dev.shape[0]
        gen = torch.Generator(device=self.device).manual_seed(
            hash((self.tc.seed, epoch_idx, s)) & 0x7FFFFFFF)
        if self.cuda:
            d0 = torch.cuda.Event(enable_timing=True)
            d1 = torch.cuda.Event(enable_timing=True)
            d0.record()
        degraded, clean = self.degrader.run(gen, _dev_widen(clean_dev), ints[bs:2 * bs],
                                            ints[2 * bs:], runs)
        if self.cuda:
            d1.record()
            self.timings.append((up_events, (d0, d1)))
        return {"degraded": degraded, "clean": clean, "task_id": ints[:bs], "step_in_epoch": s}

    # ------------------------------------------------------------------
    # resident bank
    # ------------------------------------------------------------------
    def _build_bank(self) -> None:
        n = len(self.store)
        bank_n = min(n, self.bank_patches) if self.bank_patches else n
        # in slabs, so host memory stays bounded for big stores
        slabs = []
        for s in range(0, bank_n, 256):
            host = _host_shrink(self._host_batch(np.arange(s, min(s + 256, bank_n))),
                                self.upload_dtype, pin=self.cuda)
            slabs.append(host.to(self.device, non_blocking=True))
        self._bank = torch.cat(slabs) if len(slabs) > 1 else slabs[0]
        self._next_store_idx = bank_n % n

    def _refresh_producer(self, q: queue.Queue, max_steps: int, stop: threading.Event) -> None:
        """Uploads refresh_per_step fresh patches per step (round-robin over
        bank slots and the rest of the store), ahead of the consumer."""
        try:
            n = len(self.store)
            bank_n = int(self._bank.shape[0])
            slot = 0
            for _ in range(max_steps):
                if stop.is_set():
                    return
                k = self.refresh_per_step
                store_idxs = (self._next_store_idx + np.arange(k)) % n
                self._next_store_idx = int((self._next_store_idx + k) % n)
                slots = (slot + np.arange(k)) % bank_n
                slot = int((slot + k) % bank_n)
                new = _host_shrink(self._host_batch(store_idxs), self.upload_dtype, pin=self.cuda)
                slots_t = torch.from_numpy(slots.astype(np.int64))
                _put(q, self._upload([slots_t.pin_memory() if self.cuda else slots_t, new]),
                     stop)
            _put(q, None, stop)
        except BaseException as e:  # raised in the consumer, not a hang
            _put(q, e, stop)

    def _epoch_resident(self, epoch_idx: int, max_steps: int) -> Iterator[dict]:
        if self._bank is None:
            self._build_bank()
        bank_n = int(self._bank.shape[0])
        bs = self.tc.batch_size
        order = np.random.default_rng([self.tc.seed, epoch_idx]).permutation(bank_n)
        rq: Optional[queue.Queue] = None
        stop = threading.Event()
        if self.refresh_per_step > 0:
            rq = queue.Queue(maxsize=self.prefetch)
            threading.Thread(target=self._refresh_producer, args=(rq, max_steps, stop),
                             daemon=True).start()
        try:
            for s in range(max_steps):
                up_events = None
                if rq is not None:
                    item = rq.get()
                    if isinstance(item, BaseException):
                        raise item
                    if item is not None:
                        (slots, new), up_events = item
                        self._acquire((slots, new), up_events)
                        self._bank.index_copy_(0, slots, new)
                start = (s * bs) % bank_n
                idxs = np.take(order, np.arange(start, start + bs), mode="wrap")
                ints, runs = self._step_draws(epoch_idx, s, bs)
                dev = upload(np.concatenate([ints, idxs]), self.device)
                clean = self._bank.index_select(0, dev[3 * bs:])
                yield self._degrade(epoch_idx, s, clean, dev[:3 * bs], runs, up_events)
        finally:
            stop.set()

    # ------------------------------------------------------------------
    # streaming (producer-thread) path
    # ------------------------------------------------------------------
    def epoch(self, epoch_idx: int, steps: Optional[int] = None) -> Iterator[dict]:
        """Yield device batches: degraded, clean (B, C, H, W) float32,
        task_id (B,) int64, step_in_epoch."""
        n = len(self.store)
        bs = self.tc.batch_size
        max_steps = steps if steps is not None else max(n // bs, 1)
        if self.resident:
            yield from self._epoch_resident(epoch_idx, max_steps)
            return
        order = np.random.default_rng([self.tc.seed, epoch_idx]).permutation(n)
        stop = threading.Event()

        def producer(q: queue.Queue):
            try:
                for s in range(max_steps):
                    if stop.is_set():
                        return
                    # cycle through `order` (a store can be smaller than a batch)
                    start = (s * bs) % n
                    idxs = np.take(order, np.arange(start, start + bs), mode="wrap")
                    clean = _host_shrink(self._host_batch(idxs), self.upload_dtype, pin=self.cuda)
                    ints, runs = self._step_draws(epoch_idx, s, bs)
                    ints_t = torch.from_numpy(ints)
                    dev, events = self._upload([clean, ints_t.pin_memory() if self.cuda else ints_t])
                    _put(q, (s, dev, events, runs), stop)
                _put(q, None, stop)
            except BaseException as e:  # raised in the consumer, not a hang
                _put(q, e, stop)

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        threading.Thread(target=producer, args=(q,), daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                s, dev, events, runs = item
                self._acquire(dev, events)
                yield self._degrade(epoch_idx, s, dev[0], dev[1], runs, events)
        finally:
            stop.set()

    def step_ms(self) -> List[tuple]:
        """(upload ms or None, degrade ms) per step so far (call after a
        synchronize)."""
        return [(None if up is None else up[0].elapsed_time(up[1]), dg[0].elapsed_time(dg[1]))
                for up, dg in self.timings]
