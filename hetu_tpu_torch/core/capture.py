"""Compiled steps: a fixed-shape step body captured once in a CUDA graph
and replayed after that (the port's counterpart of ``jax.jit``).

The JAX package compiles each main path once per fixed shape: the
serving engine's unified step and the graph executor's training step.
The port captures the same steps in ``torch.cuda.CUDAGraph``s:

- ``CapturedStep(name, body, pool, stream)`` holds one body, a function
  of no arguments over tensors whose storage outlives the step (static
  buffers, parameters, KV pages).  Its first call runs the body eagerly
  on ``stream`` -- that run is the step's real result, and it builds and
  loads the kernels it launches -- and then captures the body into a
  graph without running it again, so state that a step advances (the
  KV pages, Adam's moments and step count, a dropout generator) advances
  once.  Every later call is one ``replay()`` that returns the tensors
  the capture produced; the next replay overwrites them.
- The graphs of one owner (an engine, a training graph) share one memory
  pool and one side stream, and replay one at a time.
- The kernel wrappers' launch counters (``launch_counter``) are Python
  attributes that a replay does not touch, so each captured step records
  what its capture counted and adds it on every replay: a counter reads
  the launches that ran, eager or replayed.
- ``eager()`` runs the steps on the card without capturing them, as
  ``jax.disable_jit()`` runs a jitted function op by op.  It is private:
  the tests and ``tools/compare_compiled_step.py`` use it to hold the
  captured steps against the eager ones.

The training step's run levels follow the JAX package's (its jitted
step takes the gradient sums as an input and returns them): a GRAD run
adds its gradients (the mean over its micro-batches) into the graph's
gradient accumulator and updates nothing; the UPDATE run after it
applies its own gradients plus the accumulated sum -- a sum over runs,
not a mean -- and zeroes the sums; COMPUTE_ONLY runs the fetches alone.
Under capture the accumulator is static storage, allocated at the
graph's first GRAD run, before any capture that reads it: the captured
GRAD plan adds into it in place, and the captured UPDATE plan reads it
and zeroes it inside its capture (storage allocated per run would be
frozen into the first capture).  An update plan keys on whether the
accumulator exists, so one captured before the first GRAD run is not
replayed after it.  Each shape bucket of ``set_shape_buckets`` is one
plan, and so one captured graph, whose static feed buffers have the
bucket's shape.

A capture that fails raises, naming the step and the line of the port
that issued the refused operation; there is no fallback to the eager
path.  On the CPU nothing is captured: the callers run their bodies
eagerly there.
"""
from __future__ import annotations

import contextlib
import gc
import os
import traceback
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

_PORT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (wrapper function, counter attribute names) of every kernel wrapper
_COUNTERS: List[Tuple[Any, Tuple[str, ...]]] = []
_eager = [False]


def launch_counter(fn, *names: str):
    """Gives the kernel wrapper ``fn`` the counters ``names`` (default
    ``launches``), each 0, and registers them with the captured steps.
    Returns ``fn``."""
    names = names or ("launches",)
    for n in names:
        setattr(fn, n, 0)
    _COUNTERS.append((fn, names))
    return fn


def _read_counters() -> Dict[Tuple[Any, str], int]:
    return {(fn, n): getattr(fn, n) for fn, names in _COUNTERS
            for n in names}


@contextlib.contextmanager
def eager():
    """Run every captured step eagerly while the context is open: no
    capture, no replay (the counterpart of ``jax.disable_jit()``)."""
    prev, _eager[0] = _eager[0], True
    try:
        yield
    finally:
        _eager[0] = prev


def is_eager() -> bool:
    """True inside :func:`eager`."""
    return _eager[0]


def can_capture_generators() -> bool:
    """Whether this torch can give a captured graph fresh draws of a
    ``torch.Generator`` on every replay (``register_generator_state``)."""
    return hasattr(torch.cuda.CUDAGraph, "register_generator_state")


def _where(exc: BaseException) -> str:
    """The innermost frame of the port in ``exc``'s traceback, as
    ``file:line in function``: the operation that capture refused."""
    port = [f for f in traceback.extract_tb(exc.__traceback__)
            if f.filename.startswith(_PORT_ROOT)
            and not f.filename.endswith("capture.py")]
    if not port:
        return "outside the port"
    f = port[-1]
    return (f"{os.path.relpath(f.filename, os.path.dirname(_PORT_ROOT))}:"
            f"{f.lineno} in {f.name} ({f.line})")


def _tensors(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [x for x in out if isinstance(x, torch.Tensor)]
    return []


class CapturedStep:
    """One fixed-shape step body, run eagerly once and then replayed from
    a CUDA graph (see the module docstring).  ``generators`` are the
    ``torch.Generator``s the body draws from; each replay advances them
    as an eager run would."""

    def __init__(self, name: str, body: Callable[[], Any], pool,
                 stream: torch.cuda.Stream,
                 generators: Sequence[torch.Generator] = ()):
        self.name = name
        self.body = body
        self.pool = pool
        self.stream = stream
        self.generators = list(generators)
        self.graph = None
        self.outputs = None
        self.launches: Dict[Tuple[Any, str], int] = {}

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self):
        if self.graph is None:
            return self._run_and_capture()
        self.graph.replay()
        for (fn, n), c in self.launches.items():
            setattr(fn, n, getattr(fn, n) + c)
        return self.outputs

    def _run_and_capture(self):
        cur = torch.cuda.current_stream()
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = self.body()
        cur.wait_stream(self.stream)
        for t in _tensors(out):
            t.record_stream(cur)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = _read_counters()
        # Python's collector must not run inside the capture: freeing an
        # unreachable object that holds another CUDA graph destroys that
        # graph, a call a capture refuses (it invalidates the capture).
        # A recompute region runs Python in the captured backward.
        gc.collect()
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                outputs = self.body()
        except Exception as exc:
            raise RuntimeError(
                f"capturing the {self.name} failed at {_where(exc)}: "
                f"{type(exc).__name__}: {exc}") from exc
        finally:
            if was_enabled:
                gc.enable()
            after = _read_counters()
            for (fn, n) in after:
                setattr(fn, n, before.get((fn, n), 0))
        self.launches = {k: v - before.get(k, 0) for k, v in after.items()
                         if v != before.get(k, 0)}
        self.graph, self.outputs = graph, outputs
        return out


class StepCache:
    """The captured steps of one owner, by key, over one memory pool and
    one side stream (created at the first capture)."""

    def __init__(self, name: str):
        self.name = name
        self.steps: Dict[Any, CapturedStep] = {}
        self._pool = self._stream = None

    def get(self, key, body: Callable[[], Any],
            generators: Sequence[torch.Generator] = ()) -> CapturedStep:
        step = self.steps.get(key)
        if step is None:
            if self._stream is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream()
            step = self.steps[key] = CapturedStep(
                f"{self.name} {key}", body, self._pool, self._stream,
                generators)
        return step

    @property
    def captured(self) -> int:
        """Graphs captured so far."""
        return sum(s.captured for s in self.steps.values())

    def clear(self) -> None:
        """Drops every captured step (their graphs and outputs)."""
        self.steps.clear()
