"""Evaluation CLI: every mode of ``mp_hsir_tpu/cli/test_cli.py`` with its
stdout lines (reference test.py:540-645):

    Start gaussian denoise testing sigma=70
    Total Test HSIs Ids : N
    Denoise sigma=70: psnr: xx.xx, ssim: x.xxxx
    Denoise sigma=70: sam: x.xxx deg, net time: x.xxx s/cube

``--mode 0..12`` selects the degradation (``MODE_DATASETS``) and the task
prompt routed into the net (``MODE_TASK_ID``; the remote-sensing preset's
band-missing prompt is 6). Mode 10 scores only the bands that are all zero
in the degraded cube. ``--pipeline N`` (N > 1) streams: a producer thread
runs the dataset, an uploader thread copies each cube pair from pinned
memory on a side stream in ``--upload_dtype``, and the main thread keeps up
to N forward + metric steps in flight, reading back one (4,) vector per
cube. ``--auto_task`` routes each cube's task id through the FFC
classifier (``--classifier_ckpt``, a flat npz of ``checkpoint.
save_classifier_npz``; empty means seeded random weights).

``--mesh_spatial N`` (N > 1) restores each cube with its rows split over N
ranks (JAX's multi-chip eval, ``make_eval_step(mc, mesh)``): rank 0 reads
and degrades each cube, scatters its row blocks, every rank runs the
row-sharded forward on its own card (``LOCAL_RANK % cards``; ranks that
outnumber the cards share them, over gloo), and rank 0 gathers the output,
scores it and prints the same lines. Started as a plain command it spawns
its N ranks on this machine itself; under ``torchrun --nproc_per_node N``
each process is one rank. Each cube's H must be a multiple of 32 N (8 N
rows at the deepest level). With ``--pipeline`` rank 0 reads the cubes
ahead on a producer thread, as the JAX CLI pipelines its sharded step.

Run: ``python -m mp_hsir_tpu_torch.cli.test_cli --mode K --test_dir DIR
--ckpt_path assets/trained/natural_12k_f16.npz``; ``--data_type
remote_sensing`` selects the 100-band preset. It runs on the card unless
``--device cpu`` is given; the port always runs its kernels on the card,
so JAX's ``--use_pallas`` has no counterpart.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import queue
import threading
import time
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from mp_hsir_tpu_torch import resolve_device, upload
from mp_hsir_tpu_torch.checkpoint import load_classifier_npz, load_params_npz
from mp_hsir_tpu_torch.config import (
    EvalConfig, ModelConfig, natural_scene_config, remote_sensing_config,
)
from mp_hsir_tpu_torch.data.eval_datasets import MODE_DATASETS
from mp_hsir_tpu_torch.models.mp_hsir import build_model
from mp_hsir_tpu_torch.ops.kernels._route import COUNTERS, ROUTE, reset_counters
from mp_hsir_tpu_torch.ops.metrics import (
    AverageMeter, compute_psnr_ssim, compute_psnr_ssim_missing_bands, compute_sam, eval_metrics,
)
from mp_hsir_tpu_torch.parallel import distributed
from mp_hsir_tpu_torch.parallel.mesh import (
    SPATIAL_AXIS, broadcast, gather_rows, make_mesh, scatter_rows,
)
from mp_hsir_tpu_torch.utils.image import save_false_color

# the task prompt each mode routes (reference test.py:163-513)
MODE_TASK_ID = {0: 0, 1: 1, 2: 1, 3: 1, 4: 1, 5: 2, 6: 0, 7: 3, 8: 4, 9: 5, 10: 5, 11: 0, 12: 1}
BANDMIS_MODE = 10
REMOTE_SENSING_BANDMIS_TASK = 6  # reference test.py:514

MODE_SUBDIR = {
    0: "gaussian_denoise", 1: "gaussian_inid_denoise", 2: "destripe",
    3: "deadline_denoise", 4: "impulse_denoise", 5: "gaussian_deblur",
    6: "motion_deblur", 7: "super_resolution", 8: "inpaint", 9: "dehaze",
    10: "bandmis", 11: "poisson", 12: "real",
}

MODE_LABEL = {
    0: lambda c: f"Denoise sigma={c.gaussian_noise_sigma}",
    1: lambda c: f"Denoise sigma={list(c.gaussian_noise_sigmas)}",
    2: lambda c: f"Destripe stripe ratio={list(c.stripe_noise_ratio)}",
    3: lambda c: f"Deadline denoise deadline ratio={list(c.deadline_noise_ratio)}",
    4: lambda c: f"Impulse denoise impulse ratio={list(c.impulse_noise_ratio)}",
    5: lambda c: f"Gaussian deblur sigma={c.gaussian_blur_radius}",
    6: lambda c: f"Motion deblur motion radius={c.motion_blur}",
    7: lambda c: f"Super resolution downsample factor={c.downsample_factor}",
    8: lambda c: f"Inpaint mask ratio={c.mask_ratio:f}",
    9: lambda c: f"Dehaze haze omega={c.haze_omega}",
    10: lambda c: f"Bandmiss ratio={c.bandmis_ratio:f}",
    11: lambda c: f"Degrad_Id={c.degrad_id}",
    12: lambda c: f"Degrad_Id={c.degrad_id}",
}

MODE_BANNER = {
    0: lambda c: f"Start gaussian denoise testing sigma={c.gaussian_noise_sigma}",
    1: lambda c: f"Start inid gaussian denoise testing sigma={list(c.gaussian_noise_sigmas)}",
    2: lambda c: f"Start destripe testing stripe ratio={list(c.stripe_noise_ratio)}",
    3: lambda c: f"Start deadline denoise testing deadline ratio={list(c.deadline_noise_ratio)}",
    4: lambda c: f"Start impulse denoise testing impulse ratio={list(c.impulse_noise_ratio)}",
    5: lambda c: f"Start gaussian deblur testing sigma={c.gaussian_blur_radius}",
    6: lambda c: f"Start Motion deblur testing motion radius={c.motion_blur}",
    7: lambda c: f"Start super-resolution testing downsampling factor={c.downsample_factor}",
    8: lambda c: f"Start inpaint testing mask ratio ={c.mask_ratio}",
    9: lambda c: f"Start dehaze testing haze omega ={c.haze_omega}",
    10: lambda c: f"Start bandmis ratio ={c.bandmis_ratio}",
    11: lambda c: "Start poisson degradation testing (zero-shot)",
    12: lambda c: "Start real noise degradation testing",
}

PRESETS = {"natural_scene": natural_scene_config, "remote_sensing": remote_sensing_config}
# the classifier's bands and collapsed classes per preset
CLASSIFIER_SHAPES = {"natural_scene": (31, 5), "remote_sensing": (100, 6)}
UPLOAD_DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}


def load_model(ckpt_path: str, model_cfg: ModelConfig, device="cuda"):
    """Eval model on ``device``; weights from a flat-npz params artifact, or
    seeded random ones (seed 0, the same in every process and every rank)
    when ``ckpt_path`` is empty."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(model_cfg, device)
    if ckpt_path:
        load_params_npz(ckpt_path, model)
    return model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _HostCopy:
    """Device tensors copied to the host without a synchronising call: on
    the card each copy goes to pinned memory with ``non_blocking`` and an
    event marks its end, which :meth:`get` waits for."""

    def __init__(self, *tensors: torch.Tensor):
        if tensors[0].device.type != "cuda":
            self.host, self.event = [t.detach().clone() for t in tensors], None
            return
        self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for h, t in zip(self.host, tensors):
            h.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def get(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        return self.host


def make_classifier_router(classifier_ckpt: str, data_type: str, device="cuda"):
    """``route(degraded (1, C, H, W) numpy) -> int``: the FFC classifier's
    collapsed-class argmax, computed on ``device`` on the stream current in
    the calling thread. Weights from ``classifier_ckpt`` (a flat npz), or
    seeded random ones (seed 0) when it is empty."""
    from mp_hsir_tpu_torch.models.classifier import FFCResNet, predicted_task_id

    dev = resolve_device(device)
    bands, classes = CLASSIFIER_SHAPES[data_type]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = FFCResNet(in_channel=bands, num_classes=classes)
    if classifier_ckpt:
        load_classifier_npz(classifier_ckpt, model)
    model = model.to(dev).eval()

    def route(degraded: np.ndarray) -> int:
        with torch.inference_mode():
            tid = predicted_task_id(model(upload(degraded, dev)))
            return int(_HostCopy(tid).get()[0][0])

    route.classifier = model
    return route


@torch.inference_mode()
def run_mode(cfg: EvalConfig, model_cfg: ModelConfig, model=None, device="cuda",
             task_router=None) -> dict:
    """Evaluate one mode over ``cfg.test_dir``: the synchronous loop, or the
    pipelined one when ``cfg.pipeline > 1``. ``task_router``: a callable on
    the degraded host cube (1, C, H, W) that returns the task id, in place
    of the mode's fixed prompt."""
    mode = cfg.mode
    task_id = _mode_task_id(cfg, model_cfg)
    device = resolve_device(device)
    dataset = MODE_DATASETS[mode](cfg)
    if model is None:
        model = load_model(cfg.ckpt_path, model_cfg, device)
    out_dir = os.path.join(cfg.output_path, MODE_SUBDIR[mode])
    if cfg.pipeline > 1:
        return _run_mode_pipelined(cfg, model, dataset, task_id, out_dir, device, task_router)

    psnr, ssim, sam = AverageMeter(), AverageMeter(), AverageMeter()
    wall = 0.0
    warmed = set()
    for item in dataset:
        degraded = torch.from_numpy(item["degraded"][None]).to(device)
        clean = torch.from_numpy(item["clean"][None]).to(device)
        tid = task_router(item["degraded"][None]) if task_router is not None else task_id
        tid = torch.tensor([tid], device=device)
        if degraded.shape not in warmed:
            # first call per shape pays one-time set-up (kernel build and
            # load); excluded from net time as the JAX CLI excludes compile
            model(degraded, tid)
            _sync(device)
            warmed.add(degraded.shape)
        t0 = time.perf_counter()
        restored = model(degraded, tid)
        _sync(device)
        wall += time.perf_counter() - t0
        _score(mode, restored, clean, degraded, psnr, ssim, sam)
        if cfg.save_images:
            _save_images(cfg, out_dir, item["name"], item["clean"], item["degraded"],
                         restored.float().cpu().numpy())
    return _report(cfg, psnr, ssim, sam, wall / max(len(dataset), 1))


def _score(mode: int, restored, clean, degraded, psnr, ssim, sam) -> None:
    """One cube's PSNR, SSIM and SAM into the meters (mode 10: the zeroed
    bands only)."""
    if mode == BANDMIS_MODE:
        p, s, n = compute_psnr_ssim_missing_bands(restored, clean, degraded)
    else:
        p, s, n = compute_psnr_ssim(restored, clean.clamp(0, 1))
    psnr.update(p, n)
    ssim.update(s, n)
    sam.update(compute_sam(restored, clean), n)


def _mode_task_id(cfg: EvalConfig, model_cfg: ModelConfig) -> int:
    """The task prompt of ``cfg.mode``; exits on a bad mode or option."""
    if cfg.mode not in MODE_DATASETS:
        raise SystemExit(f"unknown mode {cfg.mode}")
    task_id = MODE_TASK_ID[cfg.mode]
    if cfg.mode == BANDMIS_MODE and model_cfg.task_classes == 7:
        task_id = REMOTE_SENSING_BANDMIS_TASK
    if task_id >= model_cfg.task_classes:
        raise SystemExit(f"task id {task_id} out of range for {model_cfg.task_classes} classes")
    if cfg.upload_dtype not in UPLOAD_DTYPES:
        raise SystemExit(f"upload dtype {cfg.upload_dtype} is not one of {sorted(UPLOAD_DTYPES)}")
    return task_id


def _prefetched(dataset, depth: int):
    """The dataset's items, read ahead by a producer thread up to ``depth``
    items (the file IO and the degradation overlap the forwards); the
    producer's exception is raised again here."""
    q: queue.Queue = queue.Queue(maxsize=depth)

    def producer():
        try:
            for item in dataset:
                q.put(item)
            q.put(None)
        except BaseException as e:  # noqa: BLE001 - raised again below
            q.put(_StageError(e))

    threading.Thread(target=producer, daemon=True, name="eval-producer").start()
    while True:
        item = q.get()
        if item is None:
            return
        if isinstance(item, _StageError):
            raise item.exc
        yield item


@torch.inference_mode()
def run_mode_sharded(cfg: EvalConfig, model_cfg: ModelConfig, model, axis, device,
                     task_router=None, keep_outputs: bool = False) -> dict:
    """One mode with each cube's rows split over ``axis`` (this rank's view of
    the spatial mesh axis); every rank of the axis calls it. Rank 0 reads and
    degrades each cube (ahead on a producer thread when ``cfg.pipeline`` >
    1), routes its task id, sends a header and scatters the row blocks;
    every rank runs ``model(block, tid, axis=axis)`` (timed: the forward to
    its end on the card); rank 0 gathers the output, scores it, prints the
    synchronous loop's lines and returns its dict, with ``ranks``: each
    rank's s per cube, forwards, device, backend, kernel launches and plain
    calls on the card (and, ``keep_outputs``, the restored cubes). The other
    ranks return None."""
    mode = cfg.mode
    task_id = _mode_task_id(cfg, model_cfg)
    n, rank0 = axis.size, axis.index == 0
    items = None
    if rank0:
        dataset = MODE_DATASETS[mode](cfg)
        items = iter(_prefetched(dataset, cfg.pipeline) if cfg.pipeline > 1 else dataset)
    out_dir = os.path.join(cfg.output_path, MODE_SUBDIR[mode])
    psnr, ssim, sam = AverageMeter(), AverageMeter(), AverageMeter()
    wall, n_items, forwards, outputs = 0.0, 0, 0, []
    warmed = set()
    reset_counters()
    while True:
        item = next(items, None) if rank0 else None
        head = torch.zeros(5, dtype=torch.int64, device=device)
        if item is not None:
            c, h, w = item["degraded"].shape
            tid = task_router(item["degraded"][None]) if task_router is not None else task_id
            head = torch.tensor([1, c, h, w, tid], dtype=torch.int64, device=device)
        more, c, h, w, tid = broadcast(head, axis).tolist()
        if not more:
            break
        if h % (32 * n):
            raise SystemExit(f"--mesh_spatial {n} needs H divisible by 8*{n} at the deepest level "
                             f"(a multiple of {32 * n}); got H={h}")
        degraded = (torch.from_numpy(item["degraded"][None]).to(device) if rank0 else None)
        block = torch.empty((1, c, h // n, w), dtype=torch.float32, device=device)
        block = scatter_rows(degraded, axis, block)
        tids = torch.tensor([tid], device=device)
        if block.shape not in warmed:
            # the first call per shape pays the one-time set-up, untimed
            model(block, tids, axis=axis)
            _sync(device)
            forwards += 1
            warmed.add(block.shape)
        t0 = time.perf_counter()
        out = model(block, tids, axis=axis)
        _sync(device)
        wall += time.perf_counter() - t0
        forwards += 1
        n_items += 1
        restored = gather_rows(out, axis, dim=2)
        if not rank0:
            continue
        _score(mode, restored, torch.from_numpy(item["clean"][None]).to(device), degraded,
               psnr, ssim, sam)
        if keep_outputs:
            outputs.append(restored.cpu().numpy())
        if cfg.save_images:
            _save_images(cfg, out_dir, item["name"], item["clean"], item["degraded"],
                         restored.float().cpu().numpy())
    mine = dict(sec_per_cube=wall / max(n_items, 1), forwards=forwards,
                device=str(torch.device(device.type, torch.cuda.current_device())
                           if device.type == "cuda" else device),
                backend=dist.get_backend(axis.group), plain_cuda_calls=ROUTE.plain_cuda_calls,
                launches={k: v.launches for k, v in COUNTERS.items() if v.launches})
    ranks = [None] * n
    dist.all_gather_object(ranks, mine, group=axis.group)
    if not rank0:
        return None
    suffix = f" (pipelined x{cfg.pipeline})" if cfg.pipeline > 1 else ""
    res = _report(cfg, psnr, ssim, sam, wall / max(n_items, 1), suffix)
    res["ranks"] = ranks
    if keep_outputs:
        res["outputs"] = outputs
    return res


def _mesh_rank(info, cfg: EvalConfig, model_cfg: ModelConfig, n: int, auto_task: bool,
               classifier_ckpt: str, data_type: str, keep_outputs: bool = False):
    """One rank of ``--mesh_spatial n``: its model on its card, the mesh,
    then :func:`run_mode_sharded`."""
    mesh = make_mesh(data=1, spatial=n)
    model = load_model(cfg.ckpt_path, model_cfg, info.device)
    router = None
    if auto_task and info.rank == 0:
        router = make_classifier_router(classifier_ckpt, data_type, info.device)
    return run_mode_sharded(cfg, model_cfg, model, mesh.axis(SPATIAL_AXIS), info.device,
                            router, keep_outputs)


def run_mesh(cfg: EvalConfig, model_cfg: ModelConfig, n: int, device="cuda",
             auto_task: bool = False, classifier_ckpt: str = "",
             data_type: str = "natural_scene", keep_outputs: bool = False):
    """``--mesh_spatial n``: under torchrun (``WORLD_SIZE`` set) this process
    is one of the n ranks; else it spawns the n ranks on this machine and
    waits for them. Returns rank 0's dict (None on the other ranks)."""
    args = (cfg, model_cfg, n, auto_task, classifier_ckpt, data_type, keep_outputs)
    if os.environ.get("WORLD_SIZE"):
        info = distributed.initialize_distributed(device)
        if info.world_size != n:
            raise SystemExit(f"--mesh_spatial {n} under torchrun needs {n} processes, "
                             f"got {info.world_size}")
        try:
            return _mesh_rank(info, *args)
        finally:
            distributed.shutdown()
    resolve_device(device)
    return distributed.spawn(_mesh_rank, n, *args, device=str(device))


def _save_images(cfg: EvalConfig, out_dir: str, name: str, clean, degraded, restored) -> None:
    save_false_color(clean, cfg.select_bands, os.path.join(out_dir, f"origin_{name}.png"))
    save_false_color(degraded, cfg.select_bands, os.path.join(out_dir, f"degraded_{name}.png"))
    save_false_color(np.clip(restored, 0, 1), cfg.select_bands,
                     os.path.join(out_dir, f"restored_{name}.png"))


def _report(cfg: EvalConfig, psnr, ssim, sam, sec_per_cube: float, suffix: str = "") -> dict:
    label = MODE_LABEL[cfg.mode](cfg)
    print("%s: psnr: %.2f, ssim: %.4f" % (label, psnr.avg, ssim.avg))
    print("%s: sam: %.3f deg, net time: %.3f s/cube%s" % (label, sam.avg, sec_per_cube, suffix))
    return {"psnr": psnr.avg, "ssim": ssim.avg, "sam": sam.avg, "sec_per_cube": sec_per_cube}


class _StageError:
    """A pipeline thread's exception, passed down the queues so that the
    main thread raises it (a thread that died silently would leave the main
    loop waiting forever)."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _host_to_device(a: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``a`` cast to ``dtype`` on the host, so that only ``dtype``'s bytes
    cross the link; on the card from pinned memory, non-blocking, on the
    current stream."""
    if device.type != "cuda":
        return torch.from_numpy(a).to(dtype)
    pinned = torch.empty(a.shape, dtype=dtype, pin_memory=True)
    pinned.copy_(torch.from_numpy(a))
    return pinned.to(device, non_blocking=True)


def _run_mode_pipelined(cfg: EvalConfig, model, dataset, task_id: int, out_dir: str,
                        device: torch.device, task_router=None) -> dict:
    """The streaming loop: stage 1, a producer thread (:func:`_prefetched`),
    runs the dataset (file IO and the numpy degradation); stage 2, an
    uploader thread, consults the
    router and copies each cube pair to the device on a side stream; the
    main thread makes its stream wait on the copy, widens the pair to
    float32, issues the forward and :func:`eval_metrics`, and keeps up to
    ``cfg.pipeline`` cubes in flight, each drained by reading back its (4,)
    vector (and the restored cube only when images are saved)."""
    on_card = device.type == "cuda"
    up_dtype = UPLOAD_DTYPES[cfg.upload_dtype]
    band_missing = cfg.mode == BANDMIS_MODE
    qd: queue.Queue = queue.Queue(maxsize=max(2, cfg.pipeline))
    side = torch.cuda.Stream(device) if on_card else None

    def uploader():
        try:
            with torch.cuda.stream(side) if on_card else contextlib.nullcontext():
                for item in _prefetched(dataset, max(2, cfg.pipeline)):
                    degraded = item["degraded"][None]
                    clean = item["clean"][None]
                    tid = task_router(degraded) if task_router is not None else task_id
                    dd = _host_to_device(degraded, up_dtype, device)
                    cd = _host_to_device(clean, up_dtype, device)
                    td = upload(np.array([tid], np.int64), device)
                    copied = None
                    if on_card:
                        copied = torch.cuda.Event()
                        copied.record(side)
                    host = (clean, degraded) if cfg.save_images else (None, None)
                    qd.put((item["name"], *host, dd, cd, td, copied))
            qd.put(None)
        except BaseException as e:  # noqa: BLE001 - raised again in the main thread
            qd.put(_StageError(e))

    def step(dd, cd, td):
        degraded, clean = dd.float(), cd.float()
        restored = model(degraded, td)
        vec = eval_metrics(restored, clean, degraded, band_missing)
        return _HostCopy(vec, restored) if cfg.save_images else _HostCopy(vec)

    psnr, ssim, sam = AverageMeter(), AverageMeter(), AverageMeter()
    inflight: deque = deque()
    warmed = set()
    n_items = 0
    wall = save_secs = 0.0
    t_start = None

    def drain_one():
        nonlocal save_secs
        name, clean_np, degraded_np, out = inflight.popleft()
        host = out.get()
        p, s, count, sam_v = host[0].tolist()
        count = int(round(count))
        if count > 0:
            psnr.update(p / count if band_missing else p, count)
            ssim.update(s / count if band_missing else s, count)
            sam.update(sam_v, count)
        if cfg.save_images:
            # the PNG encode is left out of the net time, as the
            # synchronous loop's time covers the forward alone
            t_sv = time.perf_counter()
            _save_images(cfg, out_dir, name, clean_np, degraded_np, host[1].float().numpy())
            save_secs += time.perf_counter() - t_sv

    threading.Thread(target=uploader, daemon=True, name="eval-uploader").start()
    cur = torch.cuda.current_stream(device) if on_card else None
    while True:
        item = qd.get()
        if item is None:
            break
        if isinstance(item, _StageError):
            raise RuntimeError("eval pipeline stage failed") from item.exc
        n_items += 1
        name, clean_np, degraded_np, dd, cd, td, copied = item
        if copied is not None:
            cur.wait_event(copied)
            for t in (dd, cd, td):
                t.record_stream(cur)
        if dd.shape not in warmed:
            if t_start is not None:
                wall += time.perf_counter() - t_start
                t_start = None
            step(dd, cd, td).get()  # set-up of a new shape, untimed
            warmed.add(dd.shape)
        if t_start is None:
            t_start = time.perf_counter()
        inflight.append((name, clean_np, degraded_np, step(dd, cd, td)))
        while len(inflight) >= cfg.pipeline:
            drain_one()
    while inflight:
        drain_one()
    if t_start is not None:
        wall += time.perf_counter() - t_start
    wall = max(wall - save_secs, 0.0)
    return _report(cfg, psnr, ssim, sam, wall / max(n_items, 1), f" (pipelined x{cfg.pipeline})")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MP-HSIR evaluation (PyTorch port)")
    p.add_argument("--seed", type=int, default=2024)
    p.add_argument("--mode", type=int, default=0, choices=sorted(MODE_DATASETS),
                   help="degradation mode 0..12")
    p.add_argument("--test_dir", type=str, required=True)
    p.add_argument("--test_degrad_dir", type=str, default="",
                   help="mode 12: the real degraded cubes, paired with --test_dir by name order")
    p.add_argument("--gaussian_noise_sigma", type=int, default=70)
    p.add_argument("--gaussian_noise_sigmas", type=int, nargs="+", default=[10, 30, 50, 70])
    # the reference's flag names, misspelling included
    p.add_argument("--stripe_nosie_ratio", type=float, nargs=2, default=[0.05, 0.15])
    p.add_argument("--deadline_nosie_ratio", type=float, nargs=2, default=[0.05, 0.15])
    p.add_argument("--impulse_nosie_ratio", type=float, nargs="+", default=[0.1, 0.3, 0.5, 0.7])
    p.add_argument("--gaussian_blur_radius", type=int, default=15)
    p.add_argument("--motion_blur_radius", type=int, nargs=2, default=[15, 45])
    p.add_argument("--downsample_factor", type=int, default=8)
    p.add_argument("--mask_ratio", type=float, default=0.9)
    p.add_argument("--haze_omega", type=float, default=1.0)
    p.add_argument("--bandmis_ratio", type=float, default=0.3)
    p.add_argument("--degrad_id", type=int, default=1,
                   help="label id printed by modes 11/12 (reference test.py:552)")
    p.add_argument("--select_bands", type=int, nargs="+", default=[27, 15, 9])
    p.add_argument("--output_path", type=str, default="output/")
    p.add_argument("--ckpt_path", type=str, default="")
    p.add_argument("--data_type", type=str, default="natural_scene", choices=sorted(PRESETS))
    p.add_argument("--no_save_images", action="store_true")
    p.add_argument("--auto_task", action="store_true",
                   help="route task ids through the degradation classifier instead of the "
                        "mode's fixed prompt")
    p.add_argument("--classifier_ckpt", type=str, default="",
                   help="flat npz of the FFC classifier (with --auto_task; empty: seeded random "
                        "weights)")
    p.add_argument("--dim", type=int, default=None, help="model width override")
    p.add_argument("--num_blocks", type=int, nargs=3, default=None, help="per-level depth override")
    p.add_argument("--pipeline", type=int, default=1,
                   help="streaming eval: keep N forward + metric steps in flight behind a "
                        "producer and an uploader thread (1 = the synchronous loop)")
    p.add_argument("--upload_dtype", type=str, default="float16", choices=sorted(UPLOAD_DTYPES),
                   help="host -> device dtype of the pipelined loop's cubes (widened to float32 "
                        "on the device); the synchronous loop uploads float32")
    p.add_argument("--mesh_spatial", type=int, default=1,
                   help="shard each cube's rows over N ranks (one card each where there are "
                        "enough); H must be divisible by 8*N at the deepest level")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = EvalConfig(
        seed=args.seed, mode=args.mode, test_dir=args.test_dir,
        test_degrad_dir=args.test_degrad_dir,
        gaussian_noise_sigma=args.gaussian_noise_sigma,
        gaussian_noise_sigmas=tuple(args.gaussian_noise_sigmas),
        stripe_noise_ratio=tuple(args.stripe_nosie_ratio),
        deadline_noise_ratio=tuple(args.deadline_nosie_ratio),
        impulse_noise_ratio=tuple(args.impulse_nosie_ratio),
        gaussian_blur_radius=args.gaussian_blur_radius,
        motion_blur=tuple(args.motion_blur_radius),
        downsample_factor=args.downsample_factor,
        mask_ratio=args.mask_ratio, haze_omega=args.haze_omega,
        bandmis_ratio=args.bandmis_ratio, degrad_id=args.degrad_id,
        select_bands=tuple(args.select_bands), output_path=args.output_path,
        ckpt_path=args.ckpt_path, save_images=not args.no_save_images,
        pipeline=args.pipeline, upload_dtype=args.upload_dtype,
    )
    model_cfg = PRESETS[args.data_type]()
    overrides = {}
    if args.dim:
        overrides["dim"] = args.dim
    if args.num_blocks:
        overrides["num_blocks"] = tuple(args.num_blocks)
    if overrides:
        model_cfg = dataclasses.replace(model_cfg, **overrides)
    if int(os.environ.get("RANK", "0")) == 0:
        print(MODE_BANNER[cfg.mode](cfg), flush=True)
    if args.mesh_spatial > 1:
        return run_mesh(cfg, model_cfg, args.mesh_spatial, args.device, args.auto_task,
                        args.classifier_ckpt, args.data_type)
    router = (make_classifier_router(args.classifier_ckpt, args.data_type, args.device)
              if args.auto_task else None)
    return run_mode(cfg, model_cfg, device=args.device, task_router=router)


if __name__ == "__main__":
    main()
