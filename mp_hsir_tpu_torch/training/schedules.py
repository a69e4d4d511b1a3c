"""Learning-rate schedules (counterparts of
``mp_hsir_tpu/training/schedules.py``): each returns a function of the
integer step that gives a Python float.

The primary schedule is the closed form of the reference's
LinearWarmupCosineAnnealingLR (utils/schedulers.py:239-348): linear warmup
from ``warmup_start_lr`` to ``base_lr`` over ``warmup_epochs`` (with the
reference's (w-1) denominator), then cosine to ``eta_min`` at
``max_epochs``. The restart schedules (utils/schedulers.py:11-237) follow.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]


def linear_warmup_cosine_annealing(base_lr: float, warmup_epochs: int, max_epochs: int,
                                   steps_per_epoch: int = 1, warmup_start_lr: float = 0.0,
                                   eta_min: float = 0.0) -> Schedule:
    """Per-step schedule; epoch = step // steps_per_epoch."""

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        if epoch < warmup_epochs:
            if warmup_epochs > 1:
                return warmup_start_lr + epoch * (base_lr - warmup_start_lr) / (warmup_epochs - 1)
            return base_lr
        denom = max(max_epochs - warmup_epochs, 1)
        return eta_min + 0.5 * (base_lr - eta_min) * (
            1 + math.cos(math.pi * (epoch - warmup_epochs) / denom))

    return schedule


def multi_step_restart(base_lr: float, milestones: Sequence[int], gamma: float = 0.1,
                       restarts: Sequence[int] = (0,),
                       restart_weights: Sequence[float] = (1.0,)) -> Schedule:
    """MultiStepLR with restarts (utils/schedulers.py:11-50)."""
    milestones = sorted(milestones)

    def schedule(step: int) -> float:
        lr = base_lr
        for m in milestones:
            if step >= m:
                lr *= gamma
        for r, w in zip(restarts, restart_weights):
            if step == r:
                lr = base_lr * w
        return lr

    return schedule


def _cumulative(periods):
    cum = [0]
    for p in periods:
        cum.append(cum[-1] + p)
    return cum


def cosine_annealing_restart(base_lr: float, periods: Sequence[int],
                             restart_weights: Sequence[float] = (1.0,),
                             eta_min: float = 0.0) -> Schedule:
    """Cosine annealing with warm restarts (utils/schedulers.py:140-188)."""
    cum = _cumulative(periods)

    def schedule(step: int) -> float:
        if step >= cum[-1]:
            return eta_min
        for i, p in enumerate(periods):
            if cum[i] <= step < cum[i + 1]:
                w = restart_weights[min(i, len(restart_weights) - 1)]
                return eta_min + w * 0.5 * (base_lr - eta_min) * (
                    1 + math.cos(math.pi * (step - cum[i]) / p))
        return 0.0

    return schedule


def linear_lr(base_lr: float, total_iter: int) -> Schedule:
    """LinearLR: lr = base * (1 - step/total_iter) (utils/schedulers.py:53-74)."""
    return lambda step: base_lr * (1.0 - step / total_iter)


def cosine_annealing_restart_cyclic(base_lr: float, periods: Sequence[int],
                                    restart_weights: Sequence[float] = (1.0,),
                                    eta_mins: Sequence[float] = (0.0,)) -> Schedule:
    """CosineAnnealingRestartCyclicLR with a per-cycle eta_min
    (utils/schedulers.py:190-237); the right edge of a cycle belongs to the
    earlier cycle, as the reference's get_position_from_periods returns."""
    cum = _cumulative(periods)

    def schedule(step: int) -> float:
        for i, p in enumerate(periods):
            if cum[i] <= step <= cum[i + 1]:
                w = restart_weights[min(i, len(restart_weights) - 1)]
                em = eta_mins[min(i, len(eta_mins) - 1)]
                return em + w * 0.5 * (base_lr - em) * (1 + math.cos(math.pi * (step - cum[i]) / p))
        return eta_mins[-1]

    return schedule


def linear_warmup_decay(warmup_steps: int, total_steps: int, cosine: bool = True,
                        linear: bool = False) -> Schedule:
    """Warmup-decay multiplier (not an lr): linear ramp over warmup_steps,
    then cosine (default) / linear / no decay to 0 at total_steps
    (utils/schedulers.py:350-372)."""
    if linear and cosine:
        raise ValueError("linear and cosine are exclusive")

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return step / max(1, warmup_steps)
        progress = (step - warmup_steps) / max(1, total_steps - warmup_steps)
        if cosine:
            return 0.5 * (1.0 + math.cos(math.pi * progress))
        if linear:
            return 1.0 - progress
        return 1.0

    return schedule


def vibrate(base_lr: float, total_iter: int) -> Schedule:
    """VibrateLR (utils/schedulers.py:76-116): a decaying triangle-wave
    multiplier."""

    def schedule(step: int) -> float:
        f = step / total_iter
        m = 0.1 if f < 1 / 8 else 0.2 if f < 1 / 4 else 0.4 if f < 1 / 2 else 0.8
        t = max(total_iter // 80, 1)
        th = t * 4 // 5
        tstep = step % t
        f2 = 2.0 * tstep / t if tstep < th else 2.0 * (t - tstep) / t
        return base_lr * max(m, f2)

    return schedule
