"""Graph-level tensor handles (counterpart of ``hetu_tpu.graph.tensor``).

A ``Tensor`` carries a static shape, a ``torch.dtype``, the ``OpNode``
that produces it, a name and its graph.  It holds no storage: variable
values live in the graph, and every other value exists only during a
``DefineAndRunGraph.run``.  Symbolic dimensions come with a later slice.
"""
from __future__ import annotations

import itertools
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..core.dtype import torch_dtype

_tensor_ids = itertools.count()


class Tensor:
    """Graph-level tensor handle."""

    def __init__(self, shape: Sequence[int], dtype: Any = "float32",
                 producer: Optional["OpNode"] = None, name: str = "",  # noqa: F821
                 graph: Optional[Any] = None, trainable: bool = False):
        self.id = next(_tensor_ids)
        try:
            self.shape = tuple(int(d) for d in shape)
        except TypeError:
            raise NotImplementedError(
                f"symbolic dims {tuple(shape)} are ported with the "
                f"shape-bucket slice; give static shapes") from None
        self.dtype: torch.dtype = torch_dtype(dtype)
        self.producer = producer
        self.name = name or f"tensor_{self.id}"
        self.graph = graph
        self.trainable = trainable

    @property
    def ndim(self) -> int:
        return len(self.shape)

    # -- value access ---------------------------------------------------------

    def get_data(self) -> torch.Tensor:
        if self.graph is None:
            raise ValueError(f"{self.name} has no graph")
        return self.graph.get_tensor_value(self)

    def numpy(self) -> np.ndarray:
        """A numpy copy of the stored value (bf16/fp16 widen to fp32)."""
        data = self.get_data().detach()
        if data.dtype in (torch.bfloat16, torch.float16):
            data = data.float()
        # the optimizer updates variables in place: never share memory
        return data.cpu().numpy().copy()

    # -- operator overloads -> ops ---------------------------------------------

    def _ops(self):
        from ..ops import functional
        return functional

    def __add__(self, other):
        return self._ops().add(self, other)

    def __radd__(self, other):
        return self._ops().add(other, self)

    def __mul__(self, other):
        return self._ops().mul(self, other)

    def __rmul__(self, other):
        return self._ops().mul(other, self)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return self._ops().reshape(self, shape)

    def __repr__(self) -> str:
        return (f"Tensor(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype})")

    def __hash__(self):
        return self.id

    def __eq__(self, other):
        return isinstance(other, Tensor) and other.id == self.id
