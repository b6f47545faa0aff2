"""Learning-rate schedules (counterpart of ``hetu_tpu.optim.schedules``).

A schedule is a callable ``step -> lr`` over a 0-d tensor: the
optimizer calls it with its step count, a tensor on the device that the
update increments in place, and multiplies the update by the result.
Everything is torch arithmetic on that tensor (``torch.where``,
``torch.cos``, no ``.item()``), so a training step captured in a CUDA
graph computes each replay's lr from that replay's step.  Pass one
anywhere an optimizer takes ``lr``::

    optim.AdamOptimizer(lr=optim.cosine_schedule(3e-4, 2000, 100_000))

``step`` is 1-based (the value used for the step that is being applied),
as in the JAX package; a Python number is accepted too.
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_schedule(lr: float):
    """Fixed lr as a schedule (identity wrapper)."""
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=_step(step).device)


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    min_lr: float = 0.0):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then cosine
    decay to ``min_lr`` at ``total_steps`` (the GPT-3/LLaMA recipe)."""
    if total_steps <= warmup_steps:
        raise ValueError(f"total_steps {total_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def lr(step):
        s = _step(step)
        warm = peak_lr * s / max(1.0, float(warmup_steps))
        frac = torch.clamp((s - warmup_steps) / (total_steps - warmup_steps),
                           0.0, 1.0)
        decay = min_lr + 0.5 * (peak_lr - min_lr) * (
            1.0 + torch.cos(math.pi * frac))
        return torch.where(s <= warmup_steps, warm, decay)
    return lr


def linear_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    min_lr: float = 0.0):
    """Linear warmup then linear decay to ``min_lr`` (the BERT recipe)."""
    if total_steps <= warmup_steps:
        raise ValueError(f"total_steps {total_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def lr(step):
        s = _step(step)
        warm = peak_lr * s / max(1.0, float(warmup_steps))
        frac = torch.clamp((s - warmup_steps) / (total_steps - warmup_steps),
                           0.0, 1.0)
        return torch.where(s <= warmup_steps, warm,
                           peak_lr + (min_lr - peak_lr) * frac)
    return lr


def step_decay_schedule(lr0: float, decay_rate: float, every: int):
    """lr0 * decay_rate ** (step // every)."""
    def lr(step):
        s = _step(step)
        return lr0 * torch.pow(decay_rate, torch.floor(s / float(every)))
    return lr
