"""Optimizers of the port (``hetu_tpu.optim`` counterpart)."""
from .optimizer import AdamOptimizer, AdamWOptimizer, Optimizer

__all__ = ["AdamOptimizer", "AdamWOptimizer", "Optimizer"]
