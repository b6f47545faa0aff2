"""Tensor constructors: placeholders and parameters (counterpart of
``hetu_tpu.graph.ctor``).

Initializers draw on the graph's device.  One given a ``seed`` draws
from its own generator; otherwise, in a graph built with a ``seed``,
from the graph's init generator, in the order the variables are
materialized; otherwise from the process-wide init stream, as in the JAX
package: each variable takes the stream's next seed when it is created,
so the weights follow creation order, and ``set_seed`` resets the
stream.  The draws are not the JAX package's (no threefry): tests that
compare the two carry weights across (``models.convert``).

On a graph with a mesh (``graph(mesh=...)``) a ``parallel_parameter``
holds the rank's shard of its global shape: its initializer draws the
global value from the stream and the rank keeps its slice, so that
every layout starts from the same weights, as in the JAX package, whose
initializers are global.  ``blocks`` (the port's own) names the blocks of
a fused dim 0 that are split one by one (``[q | k | v]``).  A
``parallel_placeholder`` has the rank's local shape; ``run`` takes the
global feed and slices it.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from .graph import Graph, get_default_graph
from .tensor import SymbolicDim, Tensor

# the process-wide init stream: the last seed handed out (``set_seed``
# sets it; the next variable takes seed + 1)
_seed_counter = [0]


def _next_seed() -> int:
    _seed_counter[0] += 1
    return _seed_counter[0]


class Initializer:
    """``init(shape, dtype, graph, stream_seed=None)``: a tensor on the
    graph's device.  ``stream_seed`` is the init stream's seed for the
    variable, where the initializer has no ``seed`` and the graph no
    init generator."""

    def __call__(self, shape, dtype: torch.dtype, graph: Graph,
                 stream_seed: Optional[int] = None) -> torch.Tensor:
        raise NotImplementedError

    def _generator(self, graph: Graph,
                   stream_seed: Optional[int]) -> torch.Generator:
        seed = getattr(self, "seed", None)
        if seed is None:
            if graph.init_generator is not None:
                return graph.init_generator
            seed = _next_seed() if stream_seed is None else stream_seed
        gen = torch.Generator(device=graph.device)
        gen.manual_seed(int(seed))
        return gen


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype, graph, stream_seed=None):
        return torch.full(shape, self.value, dtype=dtype, device=graph.device)


def _uniform(shape, lo, hi, dtype, gen, device):
    x = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return (lo + (hi - lo) * x).to(dtype)


class UniformInitializer(Initializer):
    """Uniform on ``(-lr, lr)``, or on ``lr = (lo, hi)``."""

    def __init__(self, lr: Union[float, Sequence[float]] = 0.1, seed=None):
        self.range = (-lr, lr) if np.isscalar(lr) else tuple(lr)
        self.seed = seed

    def __call__(self, shape, dtype, graph, stream_seed=None):
        return _uniform(shape, *self.range, dtype,
                        self._generator(graph, stream_seed), graph.device)


class NormalInitializer(Initializer):
    def __init__(self, mean: float = 0.0, stddev: float = 0.01, seed=None):
        self.mean, self.stddev, self.seed = mean, stddev, seed

    def __call__(self, shape, dtype, graph, stream_seed=None):
        x = torch.randn(shape, generator=self._generator(graph, stream_seed),
                        dtype=torch.float32, device=graph.device)
        return (self.mean + self.stddev * x).to(dtype)


class TruncatedNormalInitializer(NormalInitializer):
    """Normal(mean, stddev) cut at two standard deviations, as
    ``jax.random.truncated_normal(-2, 2)``: draws outside are drawn
    again."""

    def __call__(self, shape, dtype, graph, stream_seed=None):
        gen = self._generator(graph, stream_seed)
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=graph.device)
        out = x.abs() > 2.0
        while bool(out.any()):
            x[out] = torch.randn(int(out.sum()), generator=gen,
                                 dtype=torch.float32, device=graph.device)
            out = x.abs() > 2.0
        return (self.mean + self.stddev * x).to(dtype)


class XavierUniformInitializer(Initializer):
    def __init__(self, gain: float = 1.0, seed=None):
        self.gain, self.seed = gain, seed

    def __call__(self, shape, dtype, graph, stream_seed=None):
        fan_in, fan_out = _fans(shape)
        limit = self.gain * float(np.sqrt(6.0 / (fan_in + fan_out)))
        return _uniform(shape, -limit, limit, dtype,
                        self._generator(graph, stream_seed), graph.device)


class XavierNormalInitializer(Initializer):
    def __init__(self, gain: float = 1.0, seed=None):
        self.gain, self.seed = gain, seed

    def __call__(self, shape, dtype, graph, stream_seed=None):
        fan_in, fan_out = _fans(shape)
        std = self.gain * float(np.sqrt(2.0 / (fan_in + fan_out)))
        x = torch.randn(shape, generator=self._generator(graph, stream_seed),
                        dtype=torch.float32, device=graph.device)
        return (std * x).to(dtype)


class HeUniformInitializer(Initializer):
    def __init__(self, seed=None):
        self.seed = seed

    def __call__(self, shape, dtype, graph, stream_seed=None):
        fan_in, _ = _fans(shape)
        limit = float(np.sqrt(6.0 / fan_in))
        return _uniform(shape, -limit, limit, dtype,
                        self._generator(graph, stream_seed), graph.device)


class HeNormalInitializer(Initializer):
    def __init__(self, seed=None):
        self.seed = seed

    def __call__(self, shape, dtype, graph, stream_seed=None):
        fan_in, _ = _fans(shape)
        std = float(np.sqrt(2.0 / fan_in))
        x = torch.randn(shape, generator=self._generator(graph, stream_seed),
                        dtype=torch.float32, device=graph.device)
        return (std * x).to(dtype)


class ProvidedInitializer(Initializer):
    def __init__(self, data):
        self.data = data

    def __call__(self, shape, dtype, graph, stream_seed=None):
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


def _local_shape(g: Graph, global_shape: Sequence, pspec) -> tuple:
    """The rank's shape of ``global_shape`` under ``pspec`` on the graph's
    mesh; a symbolic dim stays as it is (the feed binds its local size)."""
    from ..parallel.mesh import dim_split
    out = []
    for d, size in enumerate(global_shape):
        entry = pspec[d] if pspec is not None and d < len(pspec) else None
        n, _ = dim_split(entry, g.mesh)
        if isinstance(size, SymbolicDim) or n == 1:
            out.append(size)
        elif int(size) % n:
            raise ValueError(f"dim {d} of {tuple(global_shape)} is not "
                             f"divisible by {n} shards ({pspec!r})")
        else:
            out.append(int(size) // n)
    return tuple(out)


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
    if t.is_symbolic:
        raise ValueError(f"parameter {t.name} has symbolic dims {t.shape}; "
                         f"a variable's shape is static")
    # a random initializer takes the init stream's next seed now, in
    # creation order, unless it or the graph has its own
    stream_seed = _next_seed() if hasattr(init, "seed") and \
        init.seed is None and g.init_generator is None else None
    g.add_variable(t, lambda: init(t.shape, t.dtype, g, stream_seed))
    return t


variable = parameter


def parallel_placeholder(dtype, global_shape: Sequence, ds_hierarchy=None,
                         pspec=None, name: str = "",
                         graph: Optional[Graph] = None) -> Tensor:
    """A placeholder of the rank's shard of ``global_shape`` under
    ``pspec`` (the whole shape without a mesh); ``run`` takes the global
    feed and slices it."""
    g = graph or get_default_graph()
    t = placeholder(dtype, _local_shape(g, global_shape, pspec), name, g)
    t.pspec, t.global_shape = pspec, tuple(global_shape)
    if ds_hierarchy is not None:
        t.set_ds_hierarchy(ds_hierarchy)
    return t


def parallel_parameter(init: Union[Initializer, Any], global_shape: Sequence,
                       ds_hierarchy=None, pspec=None, dtype=None,
                       name: str = "", trainable: bool = True,
                       graph: Optional[Graph] = None,
                       blocks: Optional[Sequence[int]] = None,
                       blocks_dim: int = 0,
                       units: Optional[Sequence[int]] = None) -> Tensor:
    """A parameter holding the rank's shard of ``global_shape`` under
    ``pspec`` (the whole value without a mesh).  The initializer draws
    the global value and the rank keeps its slice; ``blocks`` (sizes
    summing to dim ``blocks_dim``) splits a fused dim block by block, and
    ``units`` (heads a block) lets a block of fewer heads than shards
    repeat over them.  A ``pp`` entry keeps the rank's pipeline stage of
    a stacked weight.  The layout is read from the graph's mesh when the
    value is made, so that a strategy switch re-derives it."""
    from ..parallel.mesh import layout_shape, take_shard
    g = graph or get_default_graph()
    if not isinstance(init, Initializer):
        data = np.asarray(init)
        global_shape = data.shape if global_shape is None else global_shape
        init = ProvidedInitializer(data)
    gshape = tuple(int(d) for d in global_shape)
    blocks = tuple(blocks) if blocks else None
    units = tuple(units) if units and blocks else None
    t = Tensor(layout_shape(gshape, pspec, g.mesh, blocks, blocks_dim,
                            units) if g.mesh is not None
               else _local_shape(g, gshape, pspec), dtype or "float32",
               name=name or "param", graph=g, trainable=trainable)
    stream_seed = _next_seed() if hasattr(init, "seed") and \
        init.seed is None and g.init_generator is None else None
    g.add_variable(t, lambda: take_shard(
        init(gshape, t.dtype, g, stream_seed), t.pspec, g.mesh, blocks,
        blocks_dim, units))
    t.pspec, t.global_shape = pspec, gshape
    t.shard_blocks = blocks
    t.shard_blocks_dim = int(blocks_dim)
    t.shard_units = units
    if ds_hierarchy is not None:
        t.set_ds_hierarchy(ds_hierarchy)
    return t
