"""Tensor constructors: placeholders and parameters (counterpart of
``hetu_tpu.graph.ctor``).

Initializers draw on the graph's device from the graph's seeded
``torch.Generator`` (or their own, when given a ``seed``), in the order
the variables were created.  The draws are not the JAX package's: tests
that compare the two carry weights across (``models.convert``).  At one
device a partition spec may be ``None`` or all ``None``; sharded specs
come with the multi-GPU slice.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from .graph import Graph, get_default_graph
from .tensor import Tensor


class Initializer:
    def __call__(self, shape, dtype: torch.dtype,
                 graph: Graph) -> torch.Tensor:
        raise NotImplementedError

    def _generator(self, graph: Graph) -> torch.Generator:
        seed = getattr(self, "seed", None)
        if seed is None:
            return graph.generator
        gen = torch.Generator(device=graph.device)
        gen.manual_seed(int(seed))
        return gen


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype, graph):
        return torch.full(shape, self.value, dtype=dtype, device=graph.device)


class NormalInitializer(Initializer):
    def __init__(self, mean: float = 0.0, stddev: float = 0.01, seed=None):
        self.mean, self.stddev, self.seed = mean, stddev, seed

    def __call__(self, shape, dtype, graph):
        x = torch.randn(shape, generator=self._generator(graph),
                        dtype=torch.float32, device=graph.device)
        return (self.mean + self.stddev * x).to(dtype)


class XavierNormalInitializer(Initializer):
    def __init__(self, gain: float = 1.0, seed=None):
        self.gain, self.seed = gain, seed

    def __call__(self, shape, dtype, graph):
        fan_in, fan_out = _fans(shape)
        std = self.gain * float(np.sqrt(2.0 / (fan_in + fan_out)))
        x = torch.randn(shape, generator=self._generator(graph),
                        dtype=torch.float32, device=graph.device)
        return (std * x).to(dtype)


class ProvidedInitializer(Initializer):
    def __init__(self, data):
        self.data = data

    def __call__(self, shape, dtype, graph):
        arr = torch.as_tensor(np.asarray(self.data), device=graph.device)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"provided data shape {tuple(arr.shape)} != "
                             f"{tuple(shape)}")
        return arr.to(dtype)


def _fans(shape):
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


def _check_pspec(pspec, what: str) -> None:
    if pspec is not None and any(e is not None for e in pspec):
        raise NotImplementedError(
            f"{what}: sharded partition specs ({pspec!r}) are ported in "
            f"slice 3 (the multi-GPU mesh); at one device use None")


def placeholder(dtype=None, shape: Sequence = (), name: str = "",
                graph: Optional[Graph] = None) -> Tensor:
    g = graph or get_default_graph()
    t = Tensor(shape, dtype or "float32", name=name or "placeholder",
               graph=g)
    g.add_placeholder(t)
    return t


def parameter(init: Union[Initializer, Any], shape: Sequence = None,
              dtype=None, name: str = "", trainable: bool = True,
              graph: Optional[Graph] = None) -> Tensor:
    g = graph or get_default_graph()
    if not isinstance(init, Initializer):
        data = np.asarray(init)
        shape = data.shape if shape is None else shape
        init = ProvidedInitializer(data)
    t = Tensor(shape, dtype or "float32", name=name or "param", graph=g,
               trainable=trainable)
    g.add_variable(t, lambda: init(t.shape, t.dtype, g))
    return t


def parallel_placeholder(dtype, global_shape: Sequence, ds_hierarchy=None,
                         pspec=None, name: str = "",
                         graph: Optional[Graph] = None) -> Tensor:
    """A placeholder at one device: ``pspec`` must be ``None`` or all
    ``None``."""
    if ds_hierarchy is not None:
        raise NotImplementedError("ds_hierarchy annotations are ported in "
                                  "slice 3 (the multi-GPU mesh)")
    _check_pspec(pspec, "parallel_placeholder")
    return placeholder(dtype, global_shape, name, graph)


def parallel_parameter(init: Union[Initializer, Any], global_shape: Sequence,
                       ds_hierarchy=None, pspec=None, dtype=None,
                       name: str = "", trainable: bool = True,
                       graph: Optional[Graph] = None) -> Tensor:
    """A parameter at one device: ``pspec`` must be ``None`` or all
    ``None``."""
    if ds_hierarchy is not None:
        raise NotImplementedError("ds_hierarchy annotations are ported in "
                                  "slice 3 (the multi-GPU mesh)")
    _check_pspec(pspec, "parallel_parameter")
    return parameter(init, global_shape, dtype, name, trainable, graph=graph)
