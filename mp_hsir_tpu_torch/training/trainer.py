"""Single-device train step (counterpart of ``make_train_step`` on a
one-device mesh, ``mp_hsir_tpu/training/trainer.py:75-138``).

One step: the model's training route (bf16 compute from the config,
float32 parameters and gradients, per-sample drop-path from a
``torch.Generator``), L1 on the clamped output (reference train.py:50-67),
backward through the kernels' backward launches, then AdamW (0.9, 0.999,
eps 1e-8, decoupled weight decay) at the linear-warmup cosine learning rate.
With ``grad_accum`` = k the gradients of k micro-steps are averaged and the
optimizer updates on every k-th, as ``optax.MultiSteps`` does; the schedule
runs in optimizer updates (``trainer.py:55``). :func:`make_train_step` is
the same step over a (data, spatial, spectral) mesh of ranks (JAX's SPMD
step): each rank takes its block of the global batch, the model runs on its
rows with the spatial axis and its spectral attentions head-parallel over
the spectral axis, and the gradients and the loss are averaged over every
rank before the update, so the parameters stay bitwise equal across ranks
(``parallel/tp.py`` says why the plain mean is right for the head blocks'
weights). :func:`make_eval_step` is the inference step, on one device or
over a mesh.
"""

from __future__ import annotations

import dataclasses

import torch

from mp_hsir_tpu_torch import resolve_device
from mp_hsir_tpu_torch.config import ModelConfig, TrainConfig
from mp_hsir_tpu_torch.models.mp_hsir import MPHSIRNet, build_model
from mp_hsir_tpu_torch.parallel.mesh import (
    DATA_AXIS, MESH_AXES, SPATIAL_AXIS, SPECTRAL_AXIS, Mesh, axis_index, axis_size, broadcast,
    gather_rows, pmean_,
)
from mp_hsir_tpu_torch.training import losses
from mp_hsir_tpu_torch.training.schedules import linear_warmup_cosine_annealing


@dataclasses.dataclass
class TrainState:
    """``step`` counts train steps (micro-steps), as JAX's ``TrainState.step``;
    ``updates`` counts optimizer updates, the schedule's argument."""

    model: MPHSIRNet
    optimizer: torch.optim.AdamW
    schedule: object
    grad_accum: int
    step: int = 0
    updates: int = 0
    last_lr: float = 0.0


def make_schedule(tc: TrainConfig):
    """The per-update learning rate: optax evaluates the schedule at the
    update count before it increments, so update n (from 0) takes
    ``schedule(n)``; under grad accumulation the epoch is counted in
    updates (``trainer.py:55``)."""
    updates_per_epoch = max(tc.steps_per_epoch // max(tc.grad_accum, 1), 1)
    return linear_warmup_cosine_annealing(
        base_lr=tc.lr, warmup_epochs=int(tc.warmup_frac * tc.epochs), max_epochs=tc.epochs,
        steps_per_epoch=updates_per_epoch, eta_min=tc.eta_min)


def make_optimizer(params, tc: TrainConfig) -> torch.optim.AdamW:
    """AdamW as ``optax.adamw(sched, 0.9, 0.999, 1e-8, wd)``: the rate is set
    per update by :func:`train_step`; decoupled decay on every parameter."""
    return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=tc.weight_decay)


def create_train_state(cfg: ModelConfig, tc: TrainConfig, seed: int | None = None,
                       device: str | torch.device = "cuda", model: MPHSIRNet | None = None
                       ) -> TrainState:
    """A training-mode model (weights from ``torch.manual_seed(seed)``, or the
    given ``model``), its optimizer and schedule; the model computes in
    ``cfg.compute_dtype``. ``device`` defaults to the card and raises
    without one."""
    dev = resolve_device(device)
    if model is None:
        torch.manual_seed(tc.seed if seed is None else seed)
        model = build_model(cfg, dev, train=True)
    else:
        model.cfg = cfg
        model.to(dev).train()
    opt = make_optimizer(model.parameters(), tc)
    return TrainState(model, opt, make_schedule(tc), max(tc.grad_accum, 1))


def train_step(state: TrainState, batch: dict, generator: torch.Generator | None = None,
               axis=None, mean_axis=None, spectral=None) -> torch.Tensor:
    """One micro-step on ``batch`` (``degraded``, ``clean`` (B, C, H, W)
    float32, ``task_id`` (B,)); returns the loss (a 0-dim tensor on the
    model's device, not synchronised). Updates on every ``grad_accum``-th
    call. ``axis``: the batch is a row shard over the spatial mesh axis;
    ``spectral``: the spectral attentions run head-parallel over that mesh
    axis; ``mean_axis``: the gradients (before each update) and the returned
    loss are averaged over it (JAX's ``pmean``; the loss then
    synchronises)."""
    model = state.model
    pred = model(batch["degraded"], batch["task_id"], generator, axis=axis, spectral=spectral)
    loss = losses.l1_clamped(pred, batch["clean"])
    loss.backward()
    state.step += 1
    if state.step % state.grad_accum == 0:
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        pmean_(grads, mean_axis)
        if state.grad_accum > 1:
            for g in grads:
                g.div_(state.grad_accum)
        state.last_lr = float(state.schedule(state.updates))
        for group in state.optimizer.param_groups:
            group["lr"] = state.last_lr
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.updates += 1
    loss = loss.detach()
    if axis_size(mean_axis) > 1:
        loss = loss.clone()
        pmean_([loss], mean_axis)
    return loss


def fold_seed(seed: int, data_index: int) -> int:
    """The drop-path seed of data group ``data_index`` (JAX's ``fold_in`` of
    the data index, ``trainer.py:108``): the seed itself for group 0, so
    that a 1 x N mesh draws what one rank draws."""
    return seed if data_index == 0 else hash((seed, data_index)) & 0x7FFFFFFF


def batch_block(batch: dict, mesh: Mesh | None) -> dict:
    """This rank's block of a global batch: its data group's samples and
    its spatial member's rows (B % data and H % spatial checked); the same
    block on every member of the spectral axis."""
    if mesh is None:
        return batch
    sp, dp = mesh.axis(SPATIAL_AXIS), mesh.axis(DATA_AXIS)
    b, h = batch["degraded"].shape[0], batch["degraded"].shape[2]
    nb, nh = b // axis_size(dp), h // axis_size(sp)
    if nb * axis_size(dp) != b or nh * axis_size(sp) != h:
        raise ValueError(f"a batch of {b} x {h} rows does not split over the "
                         f"{axis_size(dp)} x {axis_size(sp)} mesh")
    b0, r0 = axis_index(dp) * nb, axis_index(sp) * nh
    return {"degraded": batch["degraded"][b0:b0 + nb, :, r0:r0 + nh].contiguous(),
            "clean": batch["clean"][b0:b0 + nb, :, r0:r0 + nh].contiguous(),
            "task_id": batch["task_id"][b0:b0 + nb]}


def sync_parameters(state: TrainState, mesh: Mesh | None) -> None:
    """Rank 0's parameters on every rank of the mesh (a seeded init or a
    checkpoint read by each rank then starts bitwise equal everywhere)."""
    ax = None if mesh is None else mesh.axis(MESH_AXES)
    if axis_size(ax) == 1:
        return
    with torch.no_grad():
        for p in state.model.parameters():
            p.copy_(broadcast(p, ax))


def make_train_step(mc: ModelConfig, tc: TrainConfig, mesh: Mesh | None = None):
    """The train step ``step(state, batch, seed) -> loss`` over ``mesh``
    (counterpart of ``make_train_step(mc, mesh)``,
    ``mp_hsir_tpu/training/trainer.py:75-138``). Every rank calls it with
    the same global batch and seed: it keeps its (data, spatial) block
    (:func:`batch_block`; the same on every member of the spectral axis),
    runs the model on its rows with the spatial axis and its spectral
    attentions head-parallel over the spectral axis, the local L1 on its
    block, then averages the gradients and the loss over every rank
    (:func:`~mp_hsir_tpu_torch.parallel.mesh.pmean_`: one flattened bucket,
    the same bits on every rank) before AdamW. The drop-path generator is
    seeded with :func:`fold_seed` of the data index: the same on the
    spatial and spectral members of a data group. Each shard must hold
    whole 8 x 8 windows at the deepest level (its rows a multiple of 32).
    ``mc`` is the model's configuration, in either compute type. ``tc``'s
    batch and patch size are checked against the mesh here."""
    sp = None if mesh is None else mesh.axis(SPATIAL_AXIS)
    dp = None if mesh is None else mesh.axis(DATA_AXIS)
    tp = None if mesh is None else mesh.axis(SPECTRAL_AXIS)
    every = None if mesh is None else mesh.axis(MESH_AXES)
    if tc.batch_size % axis_size(dp) or tc.patch_size % (32 * axis_size(sp)):
        raise ValueError(f"batch {tc.batch_size} x {tc.patch_size} rows does not split over the "
                         f"{axis_size(dp)} x {axis_size(sp)} mesh into whole 8 x 8 windows at "
                         "the deepest level (the batch a multiple of data, the patch of 32 x "
                         "spatial)")

    def step(state: TrainState, batch: dict, seed: int) -> torch.Tensor:
        if state.model.cfg != mc:
            raise ValueError("the model's configuration is not the step's")
        block = batch_block(batch, mesh)
        h = block["degraded"].shape[2]
        if h % 32:
            raise ValueError(f"a shard of {h} rows does not hold whole 8 x 8 windows at the "
                             f"deepest level (rows / 4 = {h / 4}); use fewer spatial ranks")
        dev = block["degraded"].device
        gen = torch.Generator(device=dev).manual_seed(fold_seed(seed, axis_index(dp)))
        return train_step(state, block, gen, axis=sp, mean_axis=every, spectral=tp)

    return step


def make_eval_step(mc: ModelConfig, mesh: Mesh | None = None):
    """The inference step ``infer(model, degraded (B, C, H, W), task_id (B,))
    -> restored`` (counterpart of ``make_eval_step``,
    ``mp_hsir_tpu/training/trainer.py:141-169``). With a mesh every rank
    calls it with the whole batch: the batch is split over ``data`` and each
    cube's rows over ``spatial``, each rank restores its block with the
    spatial axis and its spectral attentions head-parallel over
    ``spectral``, and every rank gets the whole output back (gathered over
    spatial and data; every spectral member holds it already). ``mc`` is
    the model's configuration (the model given must carry it), in eval
    mode."""
    sp, dp, tp = ((None, None, None) if mesh is None else
                  (mesh.axis(SPATIAL_AXIS), mesh.axis(DATA_AXIS), mesh.axis(SPECTRAL_AXIS)))

    def infer(model: MPHSIRNet, degraded, task_id):
        if model.cfg != mc:
            raise ValueError("the model's configuration is not the step's")
        b, h = degraded.shape[0], degraded.shape[2]
        nb, nh = b // axis_size(dp), h // axis_size(sp)
        if nb * axis_size(dp) != b or nh * axis_size(sp) != h:
            raise ValueError(f"a batch of {b} x {h} rows does not split over the "
                             f"{axis_size(dp)} x {axis_size(sp)} mesh")
        b0, r0 = axis_index(dp) * nb, axis_index(sp) * nh
        with torch.inference_mode():
            out = model(degraded[b0:b0 + nb, :, r0:r0 + nh].contiguous(),
                        task_id[b0:b0 + nb], axis=sp, spectral=tp)
            return gather_rows(gather_rows(out, sp, dim=2), dp, dim=0)

    return infer
