"""Restoration training CLI of the PyTorch port (counterpart of the JAX
package's ``train.py``; reference interface train.py + options.py):

    python -m mp_hsir_tpu_torch.cli.train_cli --db_path STORE [--data_type
        remote_sensing] [--epochs N] [--steps_per_epoch N] [--ckpt_dir DIR]

The flags are ``train.py``'s, plus ``--device`` (``cuda`` by default, which
raises without a card; ``cpu`` runs the plain PyTorch versions) and
``--use_kernels`` in place of ``--use_pallas`` (on by default; off runs the
model's plain versions on the card).

``--mesh_data N --mesh_spatial M`` trains over a (data, spatial) mesh of N M
ranks (JAX's SPMD step, ``make_train_step(mc, tc, mesh)``): each rank builds
the global batch as one rank does and keeps its block (its data group's
samples, its spatial member's rows), the gradients and the loss are
averaged over every rank, and the parameters stay bitwise equal on all of
them. Started as a plain command it spawns the ranks on this machine (rank
r on card r % cards; gloo where ranks share a card or run on the CPU, NCCL
with a card each); under ``torchrun --nproc_per_node N*M`` each process is
a rank. Rank 0 writes the log, TensorBoard and the checkpoints; every rank
resumes from the same checkpoint. Both compute types shard (bf16, the
default, and ``--compute_dtype float32``).

Per epoch: batches from the patch store through ``TrainPipeline`` (clean
patches uploaded, degraded and augmented on the device), one
``train_step`` each with a drop-path generator seeded per step, the loss read
to the host every ``log_every`` steps (``ckpt_dir/train_log.jsonl`` and
TensorBoard under ``ckpt_dir/tb``), a train-state checkpoint every
``ckpt_every_epochs`` epochs and at the last; at the end
``ckpt_dir/params_final.npz``. ``--ckpt_path`` warm-starts from a reference
``.ckpt`` / ``.pt`` / ``.pth`` or resumes this package's checkpoint, from the
epoch after the one it closed (the JAX loop restarts at epoch 0).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import time

import numpy as np
import torch

from mp_hsir_tpu_torch import resolve_device
from mp_hsir_tpu_torch.config import TrainConfig, natural_scene_config, remote_sensing_config
from mp_hsir_tpu_torch.data.degradations_np import default_cirrus
from mp_hsir_tpu_torch.data.patch_store import (
    DEFAULT_DATASET_NAMES, NATURAL_DATASET_NAMES, PatchStore)
from mp_hsir_tpu_torch.data.train_pipeline import TrainPipeline
from mp_hsir_tpu_torch.ops.kernels import _route
from mp_hsir_tpu_torch.parallel import distributed
from mp_hsir_tpu_torch.parallel.mesh import MESH_AXES, all_gather, make_mesh
from mp_hsir_tpu_torch.training import checkpoint as CKPT
from mp_hsir_tpu_torch.training.trainer import (
    create_train_state, make_train_step, sync_parameters,
)
from mp_hsir_tpu_torch.utils.tboard import SummaryWriter


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MP-HSIR training (PyTorch port)")
    p.add_argument("--seed", type=int, default=2024)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--patch_size", type=int, default=64)
    p.add_argument("--data_type", type=str, default="remote_sensing",
                   choices=["natural_scene", "remote_sensing"])
    p.add_argument("--de_type", nargs="+", default=None,
                   help="degradation types; defaults per data_type")
    p.add_argument("--db_path", type=str, required=True, help="HSPS patch store dir")
    p.add_argument("--ckpt_dir", type=str, default="ckpt")
    p.add_argument("--ckpt_path", type=str, default=None,
                   help="warm start (reference .ckpt/.pt/.pth) or resume (a step_* dir)")
    p.add_argument("--ckpt_every_epochs", type=int, default=50)
    p.add_argument("--steps_per_epoch", type=int, default=None)
    p.add_argument("--mesh_data", type=int, default=None,
                   help="data-parallel mesh size (ranks, each a block of the batch)")
    p.add_argument("--mesh_spatial", type=int, default=1,
                   help="spatial mesh size (ranks, each a block of the rows)")
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--upload_dtype", type=str, default="float32",
                   choices=["float32", "float16", "bfloat16", "uint16"],
                   help="host->device dtype for clean patches (uint16 = fixed-point [0,1])")
    p.add_argument("--resident_bank", action="store_true",
                   help="upload the patch store once and gather batches on the device")
    p.add_argument("--bank_patches", type=int, default=None,
                   help="cap the resident bank size (patches)")
    p.add_argument("--refresh_per_step", type=int, default=0,
                   help="fresh patches streamed into resident-bank slots per step")
    p.add_argument("--prefetch", type=int, default=2,
                   help="producer look-ahead (batches in flight)")
    p.add_argument("--dim", type=int, default=None, help="model width override")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--use_kernels", action=argparse.BooleanOptionalAction, default=True,
                   help="the hand-written kernels (default); off runs the plain versions")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    """Train; returns what was measured: the logged losses, host ms per step,
    the pipeline's upload and degrade ms per step (on the card), the
    checkpoints written, the final npz and peak device memory (rank 0's on
    a mesh, with ``mesh`` and ``same_params``: whether every rank ended
    with rank 0's parameter bits; None on the other ranks)."""
    args = build_parser().parse_args(argv)
    data = 1 if args.mesh_data is None else args.mesh_data
    spatial = args.mesh_spatial
    if data < 1 or spatial < 1:
        raise SystemExit("--mesh_data / --mesh_spatial must be at least 1")
    world = data * spatial
    if world == 1:
        return train(args, None)
    if os.environ.get("WORLD_SIZE"):
        info = distributed.initialize_distributed(args.device)
        if info.world_size != world:
            raise SystemExit(f"a {data} x {spatial} mesh under torchrun needs {world} processes, "
                             f"got {info.world_size}")
        try:
            return train(args, info)
        finally:
            distributed.shutdown()
    resolve_device(args.device)
    return distributed.spawn(_train_rank, world, args, device=args.device)


def _train_rank(info, args):
    return train(args, info)


def train(args, info) -> dict | None:
    """The training loop of one process: the whole run (``info`` None), or
    one rank of the mesh ``--mesh_data`` x ``--mesh_spatial`` whose process
    group ``info`` describes."""
    rank0 = info is None or info.rank == 0
    device = resolve_device(args.device) if info is None else info.device
    mesh = None if info is None else make_mesh(args.mesh_data or 1, args.mesh_spatial)
    natural = args.data_type == "natural_scene"
    mc = (natural_scene_config if natural else remote_sensing_config)(
        compute_dtype=args.compute_dtype)
    if args.dim:
        mc = dataclasses.replace(mc, dim=args.dim)
    target_bands = mc.in_channels

    # the source filter per data type (the reference hard-codes the remote-
    # sensing list, utils/dataset_utils.py:56)
    store = PatchStore(args.db_path,
                       dataset_names=NATURAL_DATASET_NAMES if natural else DEFAULT_DATASET_NAMES)
    steps_per_epoch = args.steps_per_epoch or max(len(store) // args.batch_size, 1)
    tc = TrainConfig(
        seed=args.seed, epochs=args.epochs, steps_per_epoch=steps_per_epoch,
        batch_size=args.batch_size, lr=args.lr, patch_size=args.patch_size,
        data_type=args.data_type, de_types=tuple(args.de_type or ()),
        db_path=args.db_path, ckpt_dir=args.ckpt_dir,
        ckpt_every_epochs=args.ckpt_every_epochs, grad_accum=args.grad_accum,
        log_every=args.log_every, upload_dtype=args.upload_dtype, resident_bank=args.resident_bank,
        bank_patches=args.bank_patches, refresh_per_step=args.refresh_per_step,
        prefetch=args.prefetch,
    )
    step = make_train_step(mc, tc, mesh)
    # cirrus templates at the training patch size (the reference resizes its
    # 512^2 haze .mats to the patch per draw)
    cirrus = (np.stack([default_cirrus(tc.patch_size, tc.patch_size, seed=s) for s in range(4)])
              if "haze" in tc.de_types_resolved() else None)
    # every rank draws the global batch, as one rank does (step keeps its block)
    pipeline = TrainPipeline(store, tc, cirrus_bank=cirrus, target_bands=target_bands,
                             prefetch=tc.prefetch, upload_dtype=tc.upload_dtype,
                             resident=tc.resident_bank, bank_patches=tc.bank_patches,
                             refresh_per_step=tc.refresh_per_step, device=device)

    state = create_train_state(mc, tc, seed=args.seed, device=device)
    if args.ckpt_path:
        if args.ckpt_path.endswith((".ckpt", ".pt", ".pth")):
            CKPT.load_reference_checkpoint(args.ckpt_path, state.model)
        else:
            CKPT.restore_checkpoint(args.ckpt_path, state)
            if rank0:
                print(f"resumed {args.ckpt_path} at step {state.step}")
    sync_parameters(state, mesh)
    start_epoch = state.step // steps_per_epoch

    log_path = os.path.join(args.ckpt_dir, "train_log.jsonl")
    if rank0:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        where = "" if mesh is None else f" mesh={mesh.data}x{mesh.spatial} backend={info.backend}"
        print(f"device={device}{where} store={len(store)} patches, {steps_per_epoch} "
              f"steps/epoch, de_types={tc.de_types_resolved()}")

    route = contextlib.nullcontext() if args.use_kernels else _route.plain_reference()
    losses, step_ms, checkpoints = [], [], []
    t0 = time.time()
    gstep = state.step
    with contextlib.ExitStack() as files, route:
        logf = files.enter_context(open(log_path, "a")) if rank0 else None
        tb = (files.enter_context(contextlib.closing(
            SummaryWriter(os.path.join(args.ckpt_dir, "tb")))) if rank0 else None)
        for epoch in range(start_epoch, args.epochs):
            t_prev = time.perf_counter()
            for batch in pipeline.epoch(epoch, steps=steps_per_epoch):
                loss = step(state, batch, hash((args.seed + 1, gstep)) & 0x7FFFFFFF)
                gstep += 1
                if gstep % args.log_every == 0:
                    lv = loss.item()
                    rec = {"step": gstep, "epoch": epoch, "train_loss": lv,
                           "wall_s": round(time.time() - t0, 1)}
                    losses.append(rec)
                    if rank0:
                        logf.write(json.dumps(rec) + "\n")
                        logf.flush()
                        tb.add_scalar("train_loss", lv, gstep)
                        print(f"epoch {epoch} step {gstep}: loss {lv:.4f}")
                now = time.perf_counter()
                step_ms.append((now - t_prev) * 1e3)
                t_prev = now
            if rank0 and ((epoch + 1) % args.ckpt_every_epochs == 0 or epoch + 1 == args.epochs):
                checkpoints.append(CKPT.save_checkpoint(args.ckpt_dir, state, state.step))
                print(f"saved checkpoint {checkpoints[-1]}")
    final = os.path.join(args.ckpt_dir, "params_final.npz")
    same = None
    if mesh is not None:
        flat = torch.cat([p.detach().reshape(-1) for p in state.model.parameters()])
        same = all(torch.equal(p, flat) for p in all_gather(flat, mesh.axis(MESH_AXES)))
    if not rank0:
        return None
    CKPT.save_params(final, state.model)
    print(f"saved params-only checkpoint {final}")
    out = {"losses": losses, "step_ms": step_ms, "checkpoints": checkpoints, "params": final,
           "steps": gstep, "pipeline_ms": [], "peak_gib": None}
    if mesh is not None:
        out.update(mesh=(mesh.data, mesh.spatial), same_params=same)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        out["pipeline_ms"] = pipeline.step_ms()
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    if len(step_ms) > 2:
        print(f"ms per step: median {statistics.median(step_ms[2:]):.2f} after 2 warm-up steps")
    print(f"done in {time.time() - t0:.0f}s")
    return out


if __name__ == "__main__":
    main()
