"""Optimizers and lr schedules of the port (``hetu_tpu.optim``
counterpart)."""
from .optimizer import (SGD, Adam, AdamOptimizer, AdamW, AdamWOptimizer,
                        AdafactorOptimizer, Optimizer, SGDOptimizer)
from .schedules import (constant_schedule, cosine_schedule, linear_schedule,
                        step_decay_schedule)

__all__ = ["Adam", "AdamOptimizer", "AdamW", "AdamWOptimizer",
           "AdafactorOptimizer", "Optimizer", "SGD", "SGDOptimizer",
           "constant_schedule", "cosine_schedule", "linear_schedule",
           "step_decay_schedule"]
