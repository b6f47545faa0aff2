"""Straggler profiling + synthetic straggler workloads (counterpart of
``hetu_tpu.elastic.straggler``).

The reference's straggler detector
(``python/elastic/engine/straggler.py:20``: per-GPU op timings written to
``HETU_STRAGGLER_LOG_FILE`` by the C++ executor and read back as relative
slowdown ratios) and its fault-injection workloads
(``workloads/cuda/workload_heavy_compute.cu`` — spin kernels launched
beside training; ``examples/malleus/test_straggler_workload.py``).

In the port a rank is a host: each rank times its own steps, and the
ranks' times are merged through the coordinator's KV store
(``rpc.coordinator``, ``kv_store=``) or, without one, by an all-gather
over the world group of ``torch.distributed``, as the JAX package merges
its hosts' times.  For tests, ratios can be injected via
``HETU_TPU_STRAGGLER_RATIOS`` (comma list) or a registered
:class:`StragglerWorkload` — the analogue of the reference's spin-kernel
injection.
"""
from __future__ import annotations

import json
import os
import time
from typing import List, Optional, Sequence


ENV_RATIOS = "HETU_TPU_STRAGGLER_RATIOS"


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0
ENV_LOG_FILE = "HETU_TPU_STRAGGLER_LOG_FILE"


class StragglerWorkload:
    """Synthetic per-device slowdown injection (fault injection for tests;
    reference workload_{heavy_compute,heavy_communicate,stall_communicate}).

    ``ratios[i]`` is the slowdown multiplier of device i (1.0 = healthy).
    When registered on a :class:`Straggler`, profiling reports these ratios
    as if they had been measured.
    """

    def __init__(self, ratios: Sequence[float]):
        self.ratios = [float(r) for r in ratios]

    def perturb(self, base_seconds: float) -> List[float]:
        return [base_seconds * r for r in self.ratios]


class Straggler:
    """Measure relative per-device slowdown ratios.

    Usage (mirrors the reference Straggler)::

        prof = Straggler(num_devices)
        prof.begin_profile()
        for _ in range(k): graph.run(...)   # timed steps
        prof.end_profile(steps=k)
        ratios = prof.read_profile()        # [1.0, 1.0, 1.7, ...]
    """

    def __init__(self, num_devices: int, kv_store=None,
                 host_id: Optional[int] = None,
                 devices_per_host: Optional[int] = None):
        live = _world_size() > 1
        self.num_devices = num_devices
        self.kv = kv_store           # coordinator KV (multi-host merge)
        # a rank is a host: its id is its rank, one device each
        self.host_id = host_id if host_id is not None else \
            (_rank() if live else 0)
        self.devices_per_host = devices_per_host or \
            (1 if live else num_devices)
        self._t0: Optional[float] = None
        self._seconds_per_step: Optional[float] = None
        self._workload: Optional[StragglerWorkload] = None

    # -- fault injection -----------------------------------------------------

    def inject(self, workload: Optional[StragglerWorkload]) -> None:
        self._workload = workload

    # -- profiling -----------------------------------------------------------

    def begin_profile(self) -> None:
        self._t0 = time.perf_counter()

    def end_profile(self, steps: int = 1) -> None:
        assert self._t0 is not None, "begin_profile not called"
        self._seconds_per_step = (time.perf_counter() - self._t0) / max(1, steps)
        self._t0 = None
        if self.kv is not None:
            self.kv.put(f"straggler/{self.host_id}",
                        json.dumps(self._seconds_per_step))
        log = os.environ.get(ENV_LOG_FILE)
        if log:
            with open(log, "a") as f:
                f.write(json.dumps({"host": self.host_id,
                                    "sec_per_step": self._seconds_per_step})
                        + "\n")

    def read_profile(self) -> List[float]:
        """Relative slowdown ratio per device (min over devices == 1.0)."""
        env = os.environ.get(ENV_RATIOS)
        if env:
            vals = [float(x) for x in env.split(",")]
            assert len(vals) == self.num_devices, \
                f"{ENV_RATIOS} has {len(vals)} entries, " \
                f"need {self.num_devices}"
            return self._normalize(vals)
        if self._workload is not None:
            base = self._seconds_per_step or 1.0
            return self._normalize(self._workload.perturb(base))
        if self.kv is not None:
            # merge per-host step times: a host's devices all inherit its time
            n_hosts = (self.num_devices + self.devices_per_host - 1) \
                // self.devices_per_host
            per_host: List[Optional[float]] = []
            for h in range(n_hosts):
                v = self.kv.get(f"straggler/{h}", timeout=5.0)
                per_host.append(float(json.loads(v)) if v is not None
                                else None)
            observed = [v for v in per_host if v is not None] \
                or [self._seconds_per_step or 1.0]
            # a host that never reported is the straggler scenario itself:
            # treat it as far slower than anything observed, never as healthy
            missing = [h for h, v in enumerate(per_host) if v is None]
            if missing:
                import warnings
                warnings.warn(f"straggler profile missing for hosts "
                              f"{missing}; treating them as 10x slowest")
                worst = max(observed) * 10.0
                per_host = [worst if v is None else v for v in per_host]
            vals = []
            for i in range(self.num_devices):
                vals.append(per_host[i // self.devices_per_host])
            return self._normalize(vals)
        if _world_size() == self.num_devices > 1 and \
                self.devices_per_host == 1:
            return self._normalize(self._gather_world())
        # one process: no per-device skew to see; everything healthy
        return [1.0] * self.num_devices

    def _gather_world(self) -> List[float]:
        """Every rank's seconds a step, by an all-gather over the world
        (every rank calls it)."""
        import torch
        import torch.distributed as dist
        mine = torch.tensor([self._seconds_per_step or 1.0],
                            dtype=torch.float64)
        if dist.get_backend() == "nccl":
            mine = mine.cuda()
        out = [torch.zeros_like(mine) for _ in range(_world_size())]
        dist.all_gather(out, mine)
        return [float(v.item()) for v in out]

    @staticmethod
    def _normalize(vals: Sequence[float]) -> List[float]:
        lo = min(vals)
        if lo <= 0:
            raise ValueError(f"non-positive straggler timing {vals}")
        return [v / lo for v in vals]
