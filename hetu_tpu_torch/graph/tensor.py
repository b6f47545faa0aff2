"""Graph-level tensor handles (counterpart of ``hetu_tpu.graph.tensor``).

A ``Tensor`` carries a shape, a ``torch.dtype``, the ``OpNode`` that
produces it, a name and its graph.  A shape may hold ``SymbolicDim``s:
named dims that a define-and-run graph binds from the shapes fed at
each run (its shape plans, ``DefineAndRunGraph.run``), and arithmetic
over them (``seq // 2``) builds ``DerivedDim``s that evaluate from their
parents at every ``get()``.  A Tensor holds no storage, except in an
``EagerGraph``, which runs each op as it is made and keeps the value on
its output (``set_data``); variable values live in the graph, and every
other value exists only during a run.
"""
from __future__ import annotations

import itertools
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.dtype import torch_dtype

_tensor_ids = itertools.count()


class SymbolicDim:
    """A named symbolic dimension with an optional current binding.

    Arithmetic composes dims into a lazily evaluated DAG: ``seq // cp *
    heads`` is a :class:`DerivedDim` that evaluates from its parents at
    every ``get()``, so rebinding a leaf reaches every derived dim."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str, value: Optional[int] = None):
        self.name = name
        self._value = None if value is None else int(value)

    def set(self, value: int) -> None:
        self._value = int(value)

    def get(self) -> int:
        if self._value is None:
            raise ValueError(f"symbolic dim {self.name!r} is unbound")
        return self._value

    @property
    def is_bound(self) -> bool:
        return self._value is not None

    def __repr__(self) -> str:
        return f"Sym({self.name}={self._value})"

    def _derive(self, op: str, fn, other, swapped: bool = False):
        if not isinstance(other, (int, SymbolicDim)):
            return NotImplemented
        a, b = (other, self) if swapped else (self, other)
        return DerivedDim(op, fn, (a, b))

    def __add__(self, o):
        return self._derive("+", lambda a, b: a + b, o)

    def __radd__(self, o):
        return self._derive("+", lambda a, b: a + b, o, swapped=True)

    def __sub__(self, o):
        return self._derive("-", lambda a, b: a - b, o)

    def __rsub__(self, o):
        return self._derive("-", lambda a, b: a - b, o, swapped=True)

    def __mul__(self, o):
        return self._derive("*", lambda a, b: a * b, o)

    def __rmul__(self, o):
        return self._derive("*", lambda a, b: a * b, o, swapped=True)

    def __floordiv__(self, o):
        return self._derive("//", lambda a, b: a // b, o)

    def __rfloordiv__(self, o):
        return self._derive("//", lambda a, b: a // b, o, swapped=True)

    def __mod__(self, o):
        return self._derive("%", lambda a, b: a % b, o)

    def __rmod__(self, o):
        return self._derive("%", lambda a, b: a % b, o, swapped=True)


class DerivedDim(SymbolicDim):
    """A dim computed from other dims.  ``get()`` evaluates from the
    parents every time; ``set()`` installs a provisional override (the
    graph binds unbound dims so), which ``clear_override`` drops."""

    __slots__ = ("_fn", "_parents")

    def __init__(self, op: str, fn, parents):
        names = [p.name if isinstance(p, SymbolicDim) else str(p)
                 for p in parents]
        super().__init__(f"({names[0]}{op}{names[1]})", None)
        self._fn = fn
        self._parents = tuple(parents)

    @staticmethod
    def _val(p) -> Optional[int]:
        if isinstance(p, SymbolicDim):
            return p.get() if p.is_bound else None
        return int(p)

    def get(self) -> int:
        if self._value is not None:       # provisional override
            return self._value
        vals = [self._val(p) for p in self._parents]
        if any(v is None for v in vals):
            raise ValueError(f"symbolic dim {self.name!r} is unbound "
                             f"(parent unbound)")
        return int(self._fn(*vals))

    @property
    def is_bound(self) -> bool:
        if self._value is not None:
            return True
        return all(self._val(p) is not None for p in self._parents)

    def clear_override(self) -> None:
        self._value = None

    def __repr__(self) -> str:
        try:
            return f"Sym({self.name}={self.get()})"
        except ValueError:
            return f"Sym({self.name}=?)"


DimLike = Union[int, SymbolicDim]


def concrete_shape(shape: Sequence[DimLike]) -> Tuple[int, ...]:
    """``shape`` with every symbolic dim at its current binding."""
    return tuple(d.get() if isinstance(d, SymbolicDim) else int(d)
                 for d in shape)


def has_symbolic(shape: Sequence[DimLike]) -> bool:
    return any(isinstance(d, SymbolicDim) for d in shape)


class Tensor:
    """Graph-level tensor handle."""

    def __init__(self, shape: Sequence[DimLike], dtype: Any = "float32",
                 producer: Optional["OpNode"] = None, name: str = "",  # noqa: F821
                 graph: Optional[Any] = None, trainable: bool = False):
        self.id = next(_tensor_ids)
        self.shape: Tuple[DimLike, ...] = tuple(
            d if isinstance(d, SymbolicDim) else int(d) for d in shape)
        self.dtype: torch.dtype = torch_dtype(dtype)
        self.producer = producer
        self.name = name or f"tensor_{self.id}"
        self.graph = graph
        self.trainable = trainable
        # the value of an op of an eager graph (EagerGraph)
        self._data: Optional[torch.Tensor] = None
        # sharding over the graph's mesh (``parallel_placeholder`` and
        # ``parallel_parameter``): the spec, the global shape the local one
        # is a shard of, the blocks of a fused dim, that dim and the heads
        # of each block, the DS annotation
        self.pspec = None
        self.global_shape: Optional[Tuple[int, ...]] = None
        self.shard_blocks: Optional[Tuple[int, ...]] = None
        self.shard_blocks_dim = 0
        self.shard_units: Optional[Tuple[int, ...]] = None
        self.ds_hierarchy = None
        # a placeholder fed to a model that splits each of the run's
        # micro-batches into ``feed_groups`` again (the SPMD pipeline):
        # its sharded feed splits into that many groups first, so that a
        # rank's part of each group is its shard of that group
        self.feed_groups = 1

    # -- sharding annotation ----------------------------------------------------

    @property
    def ds_union(self):
        if self.ds_hierarchy is None or self.ds_hierarchy.size() == 0:
            return None
        return self.ds_hierarchy.get(0)

    @property
    def distributed_states(self):
        u = self.ds_union
        return u.get_default_ds() if u is not None else None

    def set_ds_hierarchy(self, ds_hierarchy) -> None:
        """Annotates the tensor with a DS (a ``DistributedStates``, a
        union, a hierarchy or a list of them), as the JAX package's
        ``Tensor.set_ds_hierarchy``; the layout itself comes from the
        ``pspec``."""
        from ..parallel.dstates import (DistributedStates,
                                        DistributedStatesHierarchy,
                                        DistributedStatesUnion)
        if isinstance(ds_hierarchy, DistributedStatesHierarchy):
            self.ds_hierarchy = ds_hierarchy
        elif isinstance(ds_hierarchy, DistributedStatesUnion):
            self.ds_hierarchy = DistributedStatesHierarchy([ds_hierarchy])
        elif isinstance(ds_hierarchy, DistributedStates):
            self.ds_hierarchy = DistributedStatesHierarchy(
                [DistributedStatesUnion([ds_hierarchy])])
        elif isinstance(ds_hierarchy, (list, tuple)):
            self.ds_hierarchy = DistributedStatesHierarchy(
                [u if isinstance(u, DistributedStatesUnion)
                 else DistributedStatesUnion([u]) for u in ds_hierarchy])
        else:
            raise TypeError(f"bad ds annotation: {ds_hierarchy!r}")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def is_symbolic(self) -> bool:
        return has_symbolic(self.shape)

    def concrete_shape(self) -> Tuple[int, ...]:
        return concrete_shape(self.shape)

    def numel(self) -> int:
        return int(np.prod(self.concrete_shape())) if self.shape else 1

    # -- value access ---------------------------------------------------------

    def get_data(self) -> torch.Tensor:
        if self._data is not None:
            return self._data
        if self.graph is None:
            raise ValueError(f"{self.name} has no graph")
        return self.graph.get_tensor_value(self)

    def set_data(self, value: torch.Tensor) -> None:
        self._data = value

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

    def __sub__(self, other):
        return self._ops().sub(self, other)

    def __rsub__(self, other):
        return self._ops().sub(other, self)

    def __mul__(self, other):
        return self._ops().mul(self, other)

    def __rmul__(self, other):
        return self._ops().mul(other, self)

    def __truediv__(self, other):
        return self._ops().div(self, other)

    def __rtruediv__(self, other):
        return self._ops().div(other, self)

    def __neg__(self):
        return self._ops().neg(self)

    def __pow__(self, e):
        return self._ops().pow(self, e)

    def __matmul__(self, other):
        return self._ops().matmul(self, other)

    def __getitem__(self, idx):
        return self._ops().getitem(self, idx)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return self._ops().reshape(self, shape)

    def transpose(self, *perm):
        if len(perm) == 1 and isinstance(perm[0], (list, tuple)):
            perm = tuple(perm[0])
        return self._ops().transpose(self, perm or None)

    def sum(self, axis=None, keepdims=False):
        return self._ops().reduce_sum(self, axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._ops().reduce_mean(self, axis, keepdims)

    def to(self, dtype):
        return self._ops().cast(self, dtype)

    def __repr__(self) -> str:
        return (f"Tensor(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype})")

    def __hash__(self):
        return self.id

    def __eq__(self, other):
        return isinstance(other, Tensor) and other.id == self.id
