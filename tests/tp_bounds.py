"""Derives the spectral mesh axis's bounds on the CPU from the plain
versions: the flagship's eval forward and train-step gradients on the
trained weights, on 1 x 1 x 2 and 1 x 2 x 2 meshes of gloo ranks spawned
here, against one rank (plain on both sides), in float32 or bf16.

    python tests/tp_bounds.py [SIZE] [BATCH] [--bf16]

prints, per mesh, the forward's largest difference (over the output's
max-abs) on one SIZE x SIZE cube (default 128), the four worst per-tensor
gradient differences (norm-wise) of a step on BATCH (default 2) 64 x 64
patches, drop-path off, and (bf16) the gradients' difference with every
parameter's concatenated. With --bf16 it first prints the members'
composition readings of the flagship's spectral attentions in bf16 (two
members, plain versions, 2 x 64 x 64 maps of seeded operands): the members'
stats stacked against the whole call's (bitwise or not), their applies
summed against the whole apply, their backwards composed (dx summed, the
weight cotangents scattered, d comb stacked, d dp summed, d gate
averaged: each member's is the whole map's)
against the whole backward, each over the whole's max-abs. chip_smoke.py's
phase 17 holds the kernel path on the card to bounds set from these
readings (PERF.md)."""

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


DTYPE = "bfloat16" if "--bf16" in sys.argv else "float32"


def _model(train=False):
    from mp_hsir_tpu_torch.checkpoint import load_params_npz
    from mp_hsir_tpu_torch.config import natural_scene_config
    from mp_hsir_tpu_torch.models.mp_hsir import build_model

    cfg = dataclasses.replace(natural_scene_config(compute_dtype=DTYPE), drop_path_max=0.0)
    model = build_model(cfg, "cpu", train=train)
    load_params_npz(ART, model)
    return cfg, model


def _model_f32(train=False):
    """The float32 flagship on the trained weights (bf16's yardstick)."""
    from mp_hsir_tpu_torch.checkpoint import load_params_npz
    from mp_hsir_tpu_torch.config import natural_scene_config
    from mp_hsir_tpu_torch.models.mp_hsir import build_model

    cfg = dataclasses.replace(natural_scene_config(compute_dtype="float32"), drop_path_max=0.0)
    model = build_model(cfg, "cpu", train=train)
    load_params_npz(ART, model)
    return model


def compose_readings():
    """The members' composition readings in bf16 (module docstring): per
    (C, heads, gate) of the flagship's spectral attentions the worst over
    the map of each comparison."""
    from mp_hsir_tpu_torch.ops.kernels.spectral import (
        spectral_apply_bwd_plain, spectral_apply_plain, spectral_fold, spectral_stats_bwd_plain,
        spectral_stats_plain,
    )
    from mp_hsir_tpu_torch.parallel.mesh import SPECTRAL_AXIS, Axis
    from mp_hsir_tpu_torch.parallel.tp import head_block, qkv_rows

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max())

    bf = torch.bfloat16
    worst = {}
    for c, nh in ((64, 2), (128, 4), (128, 2), (256, 8)):
        for gate in ("window", "map", ""):
            g = torch.Generator().manual_seed(c + nh + len(gate))
            n = lambda *s, sc=1.0: torch.randn(*s, generator=g) * sc  # noqa: E731
            u = lambda *s, fan: (torch.rand(*s, generator=g) * 2 - 1) / fan ** 0.5  # noqa: E731
            b, h = 2, 64
            x = n(b, h, h, c).to(bf)
            wq, wd = u(3 * c, c, 1, 1, fan=c), u(3 * c, 1, 3, 3, fan=9)
            temp, wout = 1 + n(nh, 1, 1, sc=0.2), u(c, c, 1, 1, fan=c)
            gt = None
            if gate:
                gh = h // 8 if gate == "window" else h
                gt = n(b, gh, gh, c, sc=0.5).to(bf)
            dp = torch.tensor([1.25, 0.0])
            hbs = [head_block(wq, wd, temp, wout, nh, Axis(SPECTRAL_AXIS, t, 2, None, False))
                   for t in range(2)]
            whole_st = spectral_stats_plain(x, wq, wd, nh)
            sts = [spectral_stats_plain(x, hb.wqkv, hb.wdw, hb.heads) for hb in hbs]
            stacked = [torch.cat([s[i] for s in sts], dim=1) for i in range(3)]
            bitwise = all(torch.equal(a, w) for a, w in zip(stacked, whole_st))
            comb = spectral_fold(*whole_st, temp, wout)
            combs = [spectral_fold(*st, hb.temperature, hb.wout) for st, hb in zip(sts, hbs)]
            kw = lambda sc: dict(gate=None if gt is None else gt * sc, dp_scale=dp)  # noqa: E731
            whole_y = spectral_apply_plain(x, comb, wq, wd, **kw(1.0))
            ys = [spectral_apply_plain(x, cb, hb.wqkv, hb.wdw, **kw(0.5))
                  for cb, hb in zip(combs, hbs)]
            r = dict(stats_bitwise=bitwise, stats=max(rel(a, w) for a, w in zip(stacked, whole_st)),
                     apply=rel(ys[0].float() + ys[1].float(), whole_y))
            # the backwards at the same operands (cotangents seeded), composed
            dy = n(b, h, h, c).to(bf)
            dg, dn = n(b, c, c // nh, sc=1e-3), n(b, nh, c // nh, sc=1e-3)
            cl, hh = c // 2, nh // 2
            sw = spectral_stats_bwd_plain(x, wq, wd, nh, 0, None, None, 1e-5, dg, dn, 0.5 * dn)
            aw = spectral_apply_bwd_plain(x, comb, wq, wd, 0, None, None, False, kw(1.0)["gate"],
                                          dp, 1e-5, dy)
            so, ao = [], []
            for t, hb in enumerate(hbs):
                so.append(spectral_stats_bwd_plain(
                    x, hb.wqkv, hb.wdw, hh, 0, None, None, 1e-5, dg[:, t * cl:(t + 1) * cl],
                    dn[:, t * hh:(t + 1) * hh], 0.5 * dn[:, t * hh:(t + 1) * hh]))
                ao.append(spectral_apply_bwd_plain(x, comb[:, t * cl:(t + 1) * cl], hb.wqkv,
                                                   hb.wdw, 0, None, None, False, kw(0.5)["gate"],
                                                   dp, 1e-5, dy))
            rows = torch.arange(3 * c)
            idx = [qkv_rows(rows, c, cl, t) for t in range(2)]

            def scatter(outs, i, whole):
                full = torch.zeros_like(whole)
                for t in range(2):
                    full.index_add_(0, idx[t], outs[t][i])
                return full

            r["stats_bwd"] = max(rel(so[0][0].float() + so[1][0].float(), sw[0]),
                                 *(rel(scatter(so, i, sw[i]), sw[i]) for i in (1, 2)))
            ab = [rel(ao[0][0].float() + ao[1][0].float(), aw[0]),
                  *(rel(scatter(ao, i, aw[i]), aw[i]) for i in (2, 3)),
                  rel(torch.cat([o[1] for o in ao], dim=1), aw[1]),
                  rel(ao[0][8] + ao[1][8], aw[8])]
            if gt is not None:  # d gate: each member's is the whole map's (the gate's x term)
                ab.append(rel((ao[0][6].float() + ao[1][6].float()) / 2, aw[6]))
            r["apply_bwd"] = max(ab)
            worst[(c, nh, gate or "none")] = r
            print(f"  compose C={c} heads={nh} gate={gate or 'none'}: " + ", ".join(
                f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}" for k, v in r.items()),
                flush=True)
    for k in ("stats", "apply", "stats_bwd", "apply_bwd"):
        print(f"compose worst {k}: {max(v[k] for v in worst.values()):.3e}", flush=True)
    return worst


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
        grads[k] = (acc / mesh.spectral).float().numpy()
    return (out.float().numpy(), grads) if info.rank == 0 else None


def main():
    from mp_hsir_tpu_torch.training.losses import l1_clamped

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    size = int(args[0]) if args else 128
    b = int(args[1]) if len(args) > 1 else 2
    if DTYPE == "bfloat16":
        compose_readings()
    r = np.random.default_rng(0)
    x = r.random((1, 31, size, size)).astype(np.float32)
    batch = dict(degraded=r.random((b, 31, 64, 64)).astype(np.float32),
                 clean=r.random((b, 31, 64, 64)).astype(np.float32), task_id=np.arange(b) % 6)
    _, model = _model()
    with torch.inference_mode():
        one = model(torch.as_tensor(x), torch.tensor([0])).float().numpy()
    model.train()
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    pred = model(tb["degraded"], tb["task_id"].long(), torch.Generator())
    p = pred.detach().requires_grad_(True)
    l1_clamped(p, tb["clean"]).backward()
    pred.backward(p.grad)
    g1 = {k: q.grad.float().numpy().copy() for k, q in model.named_parameters()}
    noise = {}
    if DTYPE == "bfloat16":  # how far bf16 resolves each gradient: the float32 step's, same cotangent
        m32 = _model_f32(train=True)
        m32(tb["degraded"], tb["task_id"].long(), torch.Generator()).backward(p.grad.float())
        noise = {k: float(np.linalg.norm(g1[k] - q.grad.numpy()) / max(np.linalg.norm(
            q.grad.numpy()), 1e-30)) for k, q in m32.named_parameters()}
        del m32
    for shape in [(1, 1, 2), (1, 2, 2)]:
        t0 = time.time()
        out, g = distributed.spawn(rank, int(np.prod(shape)), x, [0], batch, p.grad.numpy(),
                                   shape, device="cpu")
        e = np.abs(out - one).max() / np.abs(one).max()
        rel = sorted(((float(np.linalg.norm(g[k] - g1[k]) / max(np.linalg.norm(g1[k]), 1e-30)), k)
                      for k in g1), reverse=True)
        keys = sorted(g1)
        cat = np.concatenate([g[k].ravel() for k in keys])
        cat1 = np.concatenate([g1[k].ravel() for k in keys])
        print(f"{'x'.join(map(str, shape))} {DTYPE} ({time.time() - t0:.0f} s): forward {e:.3e} "
              f"of max-abs; gradients concatenated "
              f"{np.linalg.norm(cat - cat1) / np.linalg.norm(cat1):.3e}, worst {rel[:4]}",
              flush=True)
        if noise:  # the tensors whose bf16 gradient lies within 1e-2 of the float32 one's
            res = [(e, k) for e, k in rel if noise[k] <= 1e-2]
            print(f"  where bf16 resolves the gradient ({len(res)} of {len(rel)} tensors): "
                  f"worst {res[:4]}", flush=True)


if __name__ == "__main__":
    main()
