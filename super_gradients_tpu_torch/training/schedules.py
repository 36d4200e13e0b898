"""LR schedules as plain ``step -> lr`` functions (counterpart of
``super_gradients_tpu/training/schedules.py``).

Every policy is one function of the optimizer step, warmup -> main -> cooldown
composed by :func:`build_lr_schedule`. The trainer writes
``group["lr"] = schedule(n) * group["lr_mult"]`` before optimizer update ``n``,
counting from 0 as optax's ``scale_by_learning_rate`` does. The math is the JAX
module's, in Python floats (the JAX module evaluates it in fp32).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

from super_gradients_tpu_torch.common.registry import LR_SCHEDULERS, register_lr_scheduler

Schedule = Callable[[float], float]

# pre-3.x recipe names of the schedulers
_LEGACY_NAMES = {
    "cosine": "CosineLRScheduler",
    "step": "StepLRScheduler",
    "poly": "PolyLRScheduler",
    "exp": "ExponentialLRScheduler",
    "function": "FunctionLRScheduler",
}


@register_lr_scheduler("CosineLRScheduler")
def cosine_schedule(initial_lr: float, total_steps: int, cosine_final_lr_ratio: float = 0.01, **kw) -> Schedule:
    def schedule(step):
        lr = 0.5 * initial_lr * (1.0 + math.cos(step / (total_steps + 1) * math.pi))
        return lr * (1 - cosine_final_lr_ratio) + initial_lr * cosine_final_lr_ratio

    return schedule


@register_lr_scheduler("StepLRScheduler")
def step_schedule(
    initial_lr: float,
    steps_per_epoch: int,
    lr_updates: Sequence[int] = (),
    lr_decay_factor: float = 0.1,
    step_lr_update_freq: Optional[float] = None,
    max_epochs: int = 1,
    lr_warmup_epochs: int = 0,
    **kw,
) -> Schedule:
    """Decay by ``lr_decay_factor`` at each epoch of ``lr_updates``, or every
    ``step_lr_update_freq`` epochs after warmup (the two are exclusive)."""
    if step_lr_update_freq:
        if len(lr_updates):
            raise ValueError("Parameters lr_updates and step_lr_update_freq are mutually exclusive")
        lr_updates = [
            int(math.ceil(step_lr_update_freq * x))
            for x in range(1, max_epochs)
            if lr_warmup_epochs <= int(math.ceil(step_lr_update_freq * x)) < max_epochs
        ]
    boundaries = [u * steps_per_epoch for u in sorted(lr_updates)]

    def schedule(step):
        return initial_lr * lr_decay_factor ** sum(step >= b for b in boundaries)

    return schedule


@register_lr_scheduler("PolyLRScheduler")
def poly_schedule(initial_lr: float, total_steps: int, power: float = 0.9, **kw) -> Schedule:
    def schedule(step):
        frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
        return initial_lr * (1.0 - frac) ** power

    return schedule


@register_lr_scheduler("ExponentialLRScheduler")
def exponential_schedule(initial_lr: float, steps_per_epoch: int, lr_decay_factor: float = 0.9, **kw) -> Schedule:
    def schedule(step):
        return initial_lr * lr_decay_factor ** math.floor(step / steps_per_epoch)

    return schedule


@register_lr_scheduler("FunctionLRScheduler")
def function_schedule(initial_lr: float, total_steps: int, steps_per_epoch: int, lr_schedule_function=None,
                      max_epochs: int = 1, **kw) -> Schedule:
    """A user's ``f(initial_lr, epoch, max_epochs) -> lr``, constant within an epoch."""
    if lr_schedule_function is None:
        raise ValueError("FunctionLRScheduler requires lr_schedule_function")
    table = [float(lr_schedule_function(initial_lr, e, max_epochs)) for e in range(max_epochs)]

    def schedule(step):
        return table[min(max(int(step // steps_per_epoch), 0), max_epochs - 1)]

    return schedule


def build_lr_schedule(
    lr_mode: Optional[str],
    initial_lr: float,
    max_epochs: int,
    steps_per_epoch: int,
    lr_warmup_epochs: int = 0,
    lr_warmup_steps: int = 0,
    warmup_initial_lr: Optional[float] = None,
    lr_cooldown_epochs: int = 0,
    warmup_mode: str = "LinearEpochLRWarmup",
    **scheduler_kwargs,
) -> Schedule:
    """Warmup -> scheduler -> cooldown as one ``step -> lr`` function.

    Warmup covers the first ``lr_warmup_epochs`` epochs (or ``lr_warmup_steps``
    steps); the main scheduler sees the steps after warmup, up to the total less
    warmup and cooldown, and holds its last value through the cooldown.
    """
    warmup_steps = int(lr_warmup_steps or lr_warmup_epochs * steps_per_epoch)
    cooldown_steps = int(lr_cooldown_epochs * steps_per_epoch)
    effective_total = max(max_epochs * steps_per_epoch - warmup_steps - cooldown_steps, 1)
    if warmup_initial_lr is None:
        warmup_initial_lr = initial_lr / (lr_warmup_epochs + 1) if lr_warmup_epochs > 0 else 0.0

    if lr_mode is None:
        main: Schedule = lambda step: initial_lr  # noqa: E731
    else:
        lr_mode = _LEGACY_NAMES.get(lr_mode, lr_mode)
        if lr_mode not in LR_SCHEDULERS:
            raise KeyError(f"Unknown lr_mode `{lr_mode}`; registered: {sorted(LR_SCHEDULERS)}")
        main = LR_SCHEDULERS[lr_mode](
            initial_lr=initial_lr, total_steps=effective_total, steps_per_epoch=steps_per_epoch,
            max_epochs=max_epochs, lr_warmup_epochs=lr_warmup_epochs, **scheduler_kwargs,
        )
    batch_warmup = warmup_mode == "LinearBatchLRWarmup" or lr_warmup_steps > 0

    def schedule(step):
        step = float(step)
        if step >= warmup_steps:
            return main(min(max(step - warmup_steps, 0.0), effective_total))
        if batch_warmup:
            return warmup_initial_lr + (initial_lr - warmup_initial_lr) * step / max(warmup_steps, 1)
        # epoch warmup: warmup_initial_lr at epoch 0, initial_lr at epoch lr_warmup_epochs
        epoch = math.floor(step / steps_per_epoch)
        return warmup_initial_lr + (initial_lr - warmup_initial_lr) * epoch / max(lr_warmup_epochs, 1)

    return schedule
