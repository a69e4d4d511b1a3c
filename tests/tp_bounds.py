"""Derives the spectral mesh axis's bounds on the CPU from the plain
float32 versions: the flagship's eval forward and train-step gradients on
the trained weights, on 1 x 1 x 2 and 1 x 2 x 2 meshes of gloo ranks
spawned here, against one rank (plain on both sides).

    python tests/tp_bounds.py [SIZE] [BATCH]

prints, per mesh, the forward's largest difference (over the output's
max-abs) on one SIZE x SIZE cube (default 128) and the four worst
per-tensor gradient differences (norm-wise) of a step on BATCH (default 2)
64 x 64 patches, drop-path off. chip_smoke.py's phase 17 holds the kernel
path on the card to bounds set from these readings (PERF.md)."""

import dataclasses
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_threads  # noqa: E402,F401  (one compute thread per process)
from mp_hsir_tpu_torch.parallel import distributed  # noqa: E402

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                   "trained", "natural_12k_f16.npz")


def _model(train=False):
    from mp_hsir_tpu_torch.checkpoint import load_params_npz
    from mp_hsir_tpu_torch.config import natural_scene_config
    from mp_hsir_tpu_torch.models.mp_hsir import build_model

    cfg = dataclasses.replace(natural_scene_config(compute_dtype="float32"), drop_path_max=0.0)
    model = build_model(cfg, "cpu", train=train)
    load_params_npz(ART, model)
    return cfg, model


def rank(info, x, tid, batch, cot, shape):
    """This rank's eval step on x, then its block's gradients with the loss
    cotangent ``cot``, summed over every rank over the spectral axis's size
    (each member holds the replicated gradients and n times its head
    block's); rank 0 returns both."""
    from mp_hsir_tpu_torch.parallel.mesh import (
        MESH_AXES, SPATIAL_AXIS, SPECTRAL_AXIS, all_gather, axis_index, make_mesh,
    )
    from mp_hsir_tpu_torch.training.trainer import batch_block, make_eval_step

    cfg, model = _model()
    mesh = make_mesh(*shape)
    out = make_eval_step(cfg, mesh)(model, torch.as_tensor(x), torch.as_tensor(tid))
    model.train()
    sp, tp, every = (mesh.axis(a) for a in (SPATIAL_AXIS, SPECTRAL_AXIS, MESH_AXES))
    blk = batch_block({k: torch.as_tensor(v) for k, v in batch.items()}, mesh)
    r0 = axis_index(sp) * blk["degraded"].shape[2]
    cb = torch.as_tensor(cot)[:, :, r0:r0 + blk["degraded"].shape[2]].contiguous()
    model(blk["degraded"], blk["task_id"].long(), torch.Generator(), axis=sp,
          spectral=tp).backward(cb)
    grads = {}
    for k, p in model.named_parameters():
        parts = all_gather(p.grad, every)
        acc = parts[0].clone()
        for q in parts[1:]:
            acc += q
        grads[k] = (acc / mesh.spectral).numpy()
    return (out.numpy(), grads) if info.rank == 0 else None


def main():
    from mp_hsir_tpu_torch.training.losses import l1_clamped

    size = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    b = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    r = np.random.default_rng(0)
    x = r.random((1, 31, size, size)).astype(np.float32)
    batch = dict(degraded=r.random((b, 31, 64, 64)).astype(np.float32),
                 clean=r.random((b, 31, 64, 64)).astype(np.float32), task_id=np.arange(b) % 6)
    _, model = _model()
    with torch.inference_mode():
        one = model(torch.as_tensor(x), torch.tensor([0])).numpy()
    model.train()
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    pred = model(tb["degraded"], tb["task_id"].long(), torch.Generator())
    p = pred.detach().requires_grad_(True)
    l1_clamped(p, tb["clean"]).backward()
    pred.backward(p.grad)
    g1 = {k: q.grad.numpy().copy() for k, q in model.named_parameters()}
    for shape in [(1, 1, 2), (1, 2, 2)]:
        t0 = time.time()
        out, g = distributed.spawn(rank, int(np.prod(shape)), x, [0], batch, p.grad.numpy(),
                                   shape, device="cpu")
        e = np.abs(out - one).max() / np.abs(one).max()
        rel = sorted(((float(np.linalg.norm(g[k] - g1[k]) / max(np.linalg.norm(g1[k]), 1e-30)), k)
                      for k in g1), reverse=True)
        print(f"{'x'.join(map(str, shape))} ({time.time() - t0:.0f} s): forward {e:.3e} of "
              f"max-abs; gradients worst {rel[:4]}", flush=True)


if __name__ == "__main__":
    main()
