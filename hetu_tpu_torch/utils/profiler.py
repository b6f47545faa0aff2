"""Step and memory profilers (counterpart of ``hetu_tpu.utils.profiler``).

- :class:`StepProfiler` times whole steps, discarding the warm-up ones,
  and reports mean/p50/p90.  Where there is a card it synchronizes the
  device when a step ends: a replayed CUDA graph returns as soon as it
  is launched, so without the sync ``ms/step`` would read the launch,
  not the step.
- :func:`device_memory_stats` reads ``torch.cuda.memory_stats`` under the
  JAX package's key names (``bytes_in_use``, ``peak_bytes_in_use``,
  ``bytes_limit``); the CPU has no allocator stats and reads zeros.
- :class:`MemoryProfiler` appends per-step snapshots to a JSONL log when
  ``HETU_TPU_MEMORY_PROFILE`` is set (the JAX package's variables).

- :class:`OpProfiler` replays a graph op by op on its device and times
  each (per op, by type, by module group), as the JAX package's does:
  each op runs once, then ``warmup`` more times (kernel builds and first
  launches fall outside the timing), then ``iters`` timed runs between
  two synchronizations of the card.  The ``gradients`` node (the whole
  backward, ``torch.autograd.grad`` over the replayed forward) is one
  record.
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

ENV_MEMORY_PROFILE = "HETU_TPU_MEMORY_PROFILE"
ENV_MEMORY_LOG_FILE = "HETU_TPU_MEMORY_LOG_FILE"


def device_memory_stats(device=None) -> Dict[str, int]:
    """Memory counters of ``device`` (default: the current CUDA device)
    in bytes; zeros where there is no CUDA device."""
    dev = torch.device(device) if device is not None else None
    if (dev is not None and dev.type != "cuda") or \
            not torch.cuda.is_available():
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                dev if dev is not None else 0).total_memory)}


class OpProfiler:
    """Eager-replay op profiler: walks the graph in topological order,
    running and timing each op alone, to attribute wall time per op, op
    type and name group (the reference's per-op TimeCost and SubGraph
    profile)."""

    def __init__(self, graph):
        self.graph = graph
        self.records: List[Dict[str, Any]] = []
        # the last replay's values by tensor id (the fetched loss, the
        # gradients), to hold the replay against ``graph.run``
        self.values: Dict[int, Any] = {}

    def _sync(self) -> None:
        if self.graph.device.type == "cuda":
            torch.cuda.synchronize(self.graph.device)

    def profile(self, targets: Sequence, feed_dict: Dict,
                warmup: int = 1, iters: int = 3) -> List[Dict[str, Any]]:
        """Replay the ops ``targets`` need (fetch gradient tensors to
        include the backward) on ``feed_dict``; returns the records
        (``name``, ``op_type``, ``time`` in seconds a run, ``out_shapes``)."""
        g = self.graph
        targets = list(targets)
        env: Dict[int, Any] = {}
        for t, v in feed_dict.items():
            env[t.id] = torch.as_tensor(np.asarray(v), dtype=t.dtype,
                                        device=g.device)
        topo = g._topo_from(targets)
        needs_grad = any(n.op_type == "gradients" for n in topo)
        records = []
        with torch.set_grad_enabled(needs_grad):
            for node in topo:
                if node.op_type == "placeholder":
                    continue
                if node.op_type == "constant":
                    env[node.outputs[0].id] = node.attrs["value"]
                    continue
                if node.op_type == "variable":
                    for out in node.outputs:
                        v = g._materialize_var(out)
                        env[out.id] = v.detach().requires_grad_(True) \
                            if needs_grad and out.trainable else v
                    continue
                if node.op_type == "update":
                    continue        # the optimizer: run by graph.run
                if any(t.id not in env for t in node.inputs):
                    continue
                run_once = self._runner(node, env)
                out = run_once()
                for _ in range(warmup):
                    run_once()
                self._sync()
                t0 = time.perf_counter()
                for _ in range(iters):
                    run_once()
                self._sync()
                dt = (time.perf_counter() - t0) / max(1, iters)
                flat = out if isinstance(out, (tuple, list)) else [out]
                for t, v in zip(node.outputs, flat):
                    env[t.id] = v
                records.append({
                    "name": node.name or node.op_type,
                    "op_type": node.op_type,
                    "time": dt,
                    "out_shapes": [tuple(t.shape) for t in node.outputs],
                })
        self.records = records
        self.values = env
        return records

    @staticmethod
    def _runner(node, env):
        """One run of ``node`` over ``env``'s values."""
        if node.op_type == "gradients":
            loss = env[node.attrs["loss"].id]
            xs = [env[x.id] for x in node.attrs["xs"]]

            def run_grad():
                gs = torch.autograd.grad(loss.sum() if loss.ndim else loss,
                                         xs, retain_graph=True,
                                         allow_unused=True)
                return [torch.zeros_like(x) if gi is None else gi
                        for x, gi in zip(xs, gs)]
            return run_grad
        args = [env[t.id] for t in node.inputs]
        return lambda: node.impl(*args, **node.attrs)

    # -- aggregations (reference SubGraph::profile) ---------------------------

    def by_type(self) -> Dict[str, float]:
        agg: Dict[str, float] = defaultdict(float)
        for r in self.records:
            agg[r["op_type"]] += r["time"]
        return dict(sorted(agg.items(), key=lambda kv: -kv[1]))

    def by_group(self, depth: int = 1) -> Dict[str, float]:
        """Aggregate by name prefix (module path), e.g. 'blocks0' for
        'blocks0.attn.qkv'."""
        agg: Dict[str, float] = defaultdict(float)
        for r in self.records:
            parts = r["name"].split(".")
            agg[".".join(parts[:depth])] += r["time"]
        return dict(sorted(agg.items(), key=lambda kv: -kv[1]))

    def total(self) -> float:
        return sum(r["time"] for r in self.records)

    def summary(self, top: int = 10) -> str:
        lines = [f"{'op':<28}{'type':<22}{'ms':>8}"]
        for r in sorted(self.records, key=lambda r: -r["time"])[:top]:
            lines.append(f"{r['name'][:27]:<28}{r['op_type'][:21]:<22}"
                         f"{r['time'] * 1e3:>8.3f}")
        lines.append(f"total {self.total() * 1e3:.3f} ms over "
                     f"{len(self.records)} ops")
        return "\n".join(lines)


class StepProfiler:
    """Whole-step timing: ``with prof: g.run(...)``; the first
    ``warmup`` steps (capture, kernel builds) are discarded.  The card,
    where there is one, is synchronized at the start and the end of each
    step, so the time covers the step's device work."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self._count = 0
        self._sync = torch.cuda.is_available()

    def __enter__(self):
        if self._sync:
            torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync:
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    def stats(self) -> Dict[str, float]:
        if not self.times:
            return {"mean": 0.0, "p50": 0.0, "p90": 0.0, "steps": 0}
        a = np.asarray(self.times)
        return {"mean": float(a.mean()), "p50": float(np.percentile(a, 50)),
                "p90": float(np.percentile(a, 90)), "steps": len(a)}


class MemoryProfiler:
    """Per-step memory snapshots appended to a JSONL log when enabled via
    env (reference: ``HETU_MEMORY_PROFILE=MICRO_BATCH`` +
    ``HETU_MEMORY_LOG_FILE``)."""

    def __init__(self, log_file: Optional[str] = None,
                 enabled: Optional[bool] = None):
        env_mode = os.environ.get(ENV_MEMORY_PROFILE, "")
        self.enabled = enabled if enabled is not None else bool(env_mode)
        self.log_file = log_file or os.environ.get(ENV_MEMORY_LOG_FILE)
        self.snapshots: List[Dict[str, Any]] = []

    def snapshot(self, tag: str, micro_batch_id: int = -1) -> Dict:
        if not self.enabled:
            return {}
        rec = {"tag": tag, "micro_batch_id": micro_batch_id,
               "ts": time.time(), **device_memory_stats()}
        self.snapshots.append(rec)
        if self.log_file:
            with open(self.log_file, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    def peak(self) -> int:
        return max((s["peak_bytes_in_use"] for s in self.snapshots),
                   default=0)
