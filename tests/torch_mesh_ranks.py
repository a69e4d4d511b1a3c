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


def model_rank(info, cfg, state, x, tid, shape=None):
    """The model's eval step (``make_eval_step``) on this rank, on a 1 x n
    mesh or the (data, spatial, spectral) mesh ``shape``: the whole
    restored cube."""
    from mp_hsir_tpu_torch.models.mp_hsir import build_model
    from mp_hsir_tpu_torch.training.trainer import make_eval_step

    model = build_model(cfg, "cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    step = make_eval_step(cfg, make_mesh(*(shape or (1, info.world_size))))
    out = step(model, torch.as_tensor(x), torch.as_tensor(np.asarray(tid)))
    return out.numpy() if info.rank == 0 else None


def _sum_over(t, ax):
    """The sum of a tensor over the axis's members, in axis order."""
    from mp_hsir_tpu_torch.parallel.mesh import all_gather

    return torch.stack(all_gather(t, ax)).sum(dim=0)


def collective_grads_rank(info, x, w_conv, ca, sp, cots):
    """Each differentiable collective's backward on this rank's rows: the
    loss is the sum over ranks of each rank's sum(out * cot) over its rows
    (gather_rows: over the whole gathered map on every rank). Returns rank
    0's view: the input's gradient gathered over the rows and the weight
    gradients summed over the ranks."""
    from mp_hsir_tpu_torch.models.layers import CrossAttention, _on_extended_rows
    from mp_hsir_tpu_torch.ops.conv import conv2d
    from mp_hsir_tpu_torch.ops.kernels.spectral import spectral_attention_sharded
    from mp_hsir_tpu_torch.ops.window import roll_hw

    ax = make_mesh(1, info.world_size).axis(SPATIAL_AXIS)

    def rows(a, dim=1):
        a = torch.as_tensor(a)
        n = a.shape[dim] // ax.size
        return a.narrow(dim, ax.index * n, n).contiguous()

    out = {}

    def grad_of(name, fn, *inputs, whole=False):
        leaves = [rows(a).requires_grad_() for a in inputs]
        y = fn(*leaves)
        c = torch.as_tensor(cots[name]) if whole else rows(cots[name])
        (y * c).sum().backward()
        for i, leaf in enumerate(leaves):
            out[f"{name}.dx{i}"] = gather_rows(leaf.grad, ax)

    for sh in (-4, 4):
        grad_of(f"roll{sh}", lambda t, sh=sh: roll_hw(t, sh, sh, ax), x)
    w = torch.as_tensor(w_conv)
    grad_of("conv", lambda t: conv2d(t, w, padding=1, axis=ax), x)
    grad_of("extend", lambda t: _on_extended_rows(lambda u: conv2d(u, w, padding=1), t, ax), x)
    grad_of("gather", lambda t: gather_rows(t, ax), x, whole=True)
    layer = CrossAttention(ca["c"], 2)
    layer.load_state_dict({k: torch.as_tensor(v) for k, v in ca["state"].items()})
    grad_of("cross", lambda q, kv: layer(q, kv, axis=ax), ca["q"], ca["kv"])
    for k, p in layer.named_parameters():
        out[f"cross.{k}"] = _sum_over(p.grad, ax)
    g = {k: torch.as_tensor(v).requires_grad_() for k, v in sp.items() if k != "x"}
    grad_of("spectral", lambda t: spectral_attention_sharded(
        t, g["wqkv"], g["wdw"], g["temp"], g["wout"], 2, ax, ln_w=g["ln_w"], ln_b=g["ln_b"],
        residual=True), sp["x"])
    for k, v in g.items():
        out[f"spectral.{k}"] = _sum_over(v.grad, ax)
    return {k: v.numpy() for k, v in out.items()} if info.rank == 0 else None


def pgsstb_grads_rank(info, blocks, x, cot, dps):
    """Each PGSSTB of ``blocks`` ((constructor kwargs, state) pairs) on the
    training route on this rank's rows with drop-path scales ``dps``: loss
    sum(y * cot) over its rows; returns rank 0's view: the parameter
    gradients summed over the ranks, the input gradient gathered."""
    from mp_hsir_tpu_torch.models.layers import PGSSTB

    ax = make_mesh(1, info.world_size).axis(SPATIAL_AXIS)
    n = x.shape[1] // ax.size
    xs = torch.as_tensor(x)[:, ax.index * n:(ax.index + 1) * n].contiguous()
    cs = torch.as_tensor(cot)[:, ax.index * n:(ax.index + 1) * n]
    res = []
    for kw, state in blocks:
        blk = PGSSTB(**kw).train()
        blk.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
        xl = xs.clone().requires_grad_()
        y = blk(xl, tuple(torch.as_tensor(d) for d in dps), ax)
        (y * cs).sum().backward()
        grads = {k: _sum_over(p.grad, ax).numpy() for k, p in blk.named_parameters()}
        res.append((grads, gather_rows(xl.grad, ax).numpy()))
    return res if info.rank == 0 else None


def train_step_rank(info, cfg, tc, state, batches, seeds, keep_grads=False):
    """``make_train_step(cfg, tc, mesh)`` on a data x spatial [x spectral]
    mesh (the mesh's shape in ``tc``'s ``mesh`` entry), one step per
    batch from the same parameters on every rank: rank 0's losses and
    parameters, and whether every rank's parameters are bitwise rank 0's;
    ``keep_grads``: the first step's averaged gradients too (the update's
    learning rate is then irrelevant)."""
    from mp_hsir_tpu_torch.models.mp_hsir import build_model
    from mp_hsir_tpu_torch.parallel.mesh import MESH_AXES
    from mp_hsir_tpu_torch.training.trainer import (
        create_train_state, make_train_step, sync_parameters,
    )

    mesh = make_mesh(*tc.pop("mesh"))
    from mp_hsir_tpu_torch.config import TrainConfig

    tcfg = TrainConfig(**tc)
    model = build_model(cfg, "cpu", train=True)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    st = create_train_state(cfg, tcfg, device="cpu", model=model)
    sync_parameters(st, mesh)
    step = make_train_step(cfg, tcfg, mesh)
    grads = None
    if keep_grads:  # capture the averaged gradients before the optimizer consumes them
        opt_step = st.optimizer.step

        def capture():
            nonlocal grads
            if grads is None:
                grads = {k: p.grad.clone() for k, p in model.named_parameters()
                         if p.grad is not None}
            opt_step()

        st.optimizer.step = capture
    losses = []
    for b, s in zip(batches, seeds):
        batch = {k: torch.as_tensor(v) for k, v in b.items()}
        batch["task_id"] = batch["task_id"].long()
        losses.append(float(step(st, batch, s)))
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    flat = torch.cat([v.reshape(-1) for v in params.values()])
    every = mesh.axis(MESH_AXES)
    from mp_hsir_tpu_torch.parallel.mesh import all_gather

    same = all(torch.equal(p, flat) for p in all_gather(flat, every)) if every else True
    if info.rank:
        return None
    return dict(losses=losses, same=same, params={k: v.numpy() for k, v in params.items()},
                grads=None if grads is None else {k: v.numpy() for k, v in grads.items()})


def tp_grads_rank(info, sa, blocks, x, cot=None):
    """On a 1 x 1 x n mesh: the spectral attention of ``sa`` (its
    constructor arguments, state and input) head-parallel over the spectral
    axis, loss sum(y^2), and each PGSSTB of ``blocks`` ((constructor kwargs,
    state) pairs) on the training route with its spectral attention
    head-parallel on ``x``, loss sum(y^2) (JAX's test_model.py /
    test_pallas_vjp.py TP set-ups). Returns rank 0's view: each loss and the
    gradients averaged over the ranks (the trainer's pmean), whether every
    rank's forward was the same, and the route counters."""
    from mp_hsir_tpu_torch.models import layers
    from mp_hsir_tpu_torch.models.layers import PGSSTB, SpectralAttention
    from mp_hsir_tpu_torch.parallel.mesh import SPECTRAL_AXIS, all_gather, pmean_

    tp = make_mesh(1, 1, info.world_size).axis(SPECTRAL_AXIS)

    def mean_grads(mod):
        grads = [p.grad for _, p in mod.named_parameters()]
        pmean_(grads, tp)
        return {k: p.grad.numpy() for k, p in mod.named_parameters()}

    out, same = [], True
    layers.reset_path_stats()
    layer = SpectralAttention(*sa["args"])
    layer.load_state_dict({k: torch.as_tensor(v) for k, v in sa["state"].items()})
    y = layer.tp(torch.as_tensor(sa["x"]), tp)
    loss = y.square().sum()
    loss.backward()
    same &= all(torch.equal(p, y.detach()) for p in all_gather(y, tp))
    out.append((float(loss), mean_grads(layer)))
    for kw, state in blocks:
        blk = PGSSTB(**kw).train()
        blk.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
        xl = torch.as_tensor(x).clone().requires_grad_()
        y = blk(xl, None, None, tp)
        loss = y.square().sum()
        loss.backward()
        same &= all(torch.equal(p, y.detach()) for p in all_gather(y, tp))
        g = mean_grads(blk)
        gx = xl.grad.clone()
        pmean_([gx], tp)
        g["x"] = gx.numpy()
        out.append((float(loss), g))
    paths = dict(layers.PATH_STATS)
    return dict(results=out, same=same, paths=paths) if info.rank == 0 else None
