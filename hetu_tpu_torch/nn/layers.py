"""Layers (counterpart of ``hetu_tpu.nn.layers``): what the model uses."""
from __future__ import annotations

from ..ops import functional as ops
from .module import Module


class Dropout(Module):
    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return ops.dropout(x, self.p, training=self.training)
