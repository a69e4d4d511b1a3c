"""Rank functions of tests/test_torch_mesh.py: each runs in a process of
its own (``mp_hsir_tpu_torch.parallel.distributed.spawn``, gloo on the CPU)
and returns rank 0's view of the gathered results. Imports no JAX, so that
the spawned ranks start quickly."""

import numpy as np
import torch

import torch_threads  # noqa: F401  (one compute thread per process)
from mp_hsir_tpu_torch.parallel.mesh import SPATIAL_AXIS, gather_rows, make_mesh


def ops_rank(info, x_roll, x_conv, w_conv, w_dw, prompts, ca, sp):
    """Each sharded op on this rank's rows, gathered: roll_hw by (-4, -4) and
    (4, 4), the halo 3x3 conv and depthwise conv, the bilinear row block,
    CrossAttention with its summed statistics, and the sharded spectral
    attention (halo rows, summed stats, fold, apply with gate and
    shortcut)."""
    from mp_hsir_tpu_torch.models.layers import CrossAttention
    from mp_hsir_tpu_torch.ops.conv import conv2d, depthwise_conv2d
    from mp_hsir_tpu_torch.ops.kernels.spectral import spectral_attention_sharded
    from mp_hsir_tpu_torch.ops.resize import resize_bilinear_row_block
    from mp_hsir_tpu_torch.ops.window import roll_hw

    ax = make_mesh(1, info.world_size).axis(SPATIAL_AXIS)

    def rows(a, dim=1):
        a = torch.as_tensor(a)
        n = a.shape[dim] // ax.size
        return a.narrow(dim, ax.index * n, n).contiguous()

    out = {}
    xr = rows(x_roll)
    for sh in (-4, 4):
        out[f"roll{sh}"] = gather_rows(roll_hw(xr, sh, sh, ax), ax)
    xc = rows(x_conv)
    out["conv"] = gather_rows(conv2d(xc, torch.as_tensor(w_conv), padding=1, axis=ax), ax)
    out["dwconv"] = gather_rows(depthwise_conv2d(xc, torch.as_tensor(w_dw), axis=ax), ax)
    p = torch.as_tensor(prompts)
    h = 24 // ax.size
    out["resize"] = gather_rows(resize_bilinear_row_block(p, 24, 20, ax.index * h, h), ax)
    layer = CrossAttention(ca["c"], 2)
    layer.load_state_dict({k: torch.as_tensor(v) for k, v in ca["state"].items()})
    with torch.no_grad():
        out["cross"] = gather_rows(layer(rows(ca["q"]), rows(ca["kv"]), axis=ax), ax)
    g = {k: torch.as_tensor(v) for k, v in sp.items()}
    out["spectral"] = gather_rows(spectral_attention_sharded(
        rows(g["x"]), g["wqkv"], g["wdw"], g["temp"], g["wout"], 2, ax,
        gate=rows(g["gate"]), shortcut=rows(g["short"])), ax)
    return {k: v.numpy() for k, v in out.items()} if info.rank == 0 else None


def model_rank(info, cfg, state, x, tid):
    """The model's row-sharded eval step (``make_eval_step`` on a 1 x n
    mesh) on this rank: the whole restored cube."""
    from mp_hsir_tpu_torch.models.mp_hsir import build_model
    from mp_hsir_tpu_torch.training.trainer import make_eval_step

    model = build_model(cfg, "cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    step = make_eval_step(cfg, make_mesh(1, info.world_size))
    out = step(model, torch.as_tensor(x), torch.as_tensor(np.asarray(tid)))
    return out.numpy() if info.rank == 0 else None
