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

The per-op :class:`OpProfiler` replays a graph op by op; it is ported with
the tracing slice (ROADMAP queue 1, item 15) and raises until then.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

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
    """Per-op eager replay of a graph; ported with the tracing slice."""

    def __init__(self, graph=None):
        raise NotImplementedError(
            "OpProfiler (per-op replay) is ported with the tracing slice "
            "(ROADMAP queue 1, item 15)")


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
