"""Multi-process launcher with heartbeat monitoring and a restart policy
(port of ``hetu_tpu.rpc.launcher``, stdlib only).

The re-expression of the reference's parallel-SSH launcher
(``python/hetu/rpc/pssh_start.py:16``): read a YAML hostfile (addrs,
workers per host, ``max_restart_times``, ``heartbeat_interval``), start the
coordinator, spawn workers locally via subprocess or remotely via ssh, and
monitor heartbeats — restarting dead workers up to the restart budget
(failure detection; the reference kills the process group on worker
exceptions, ``examples/gpt/train_hetu.py:421-426``).

Hostfile format (mirrors ``examples/hydraulis/scripts/host_example.yaml``)::

    hosts:
      - addr: localhost
        initial_workers: 4
      - addr: 10.0.0.2
        initial_workers: 4
    max_restart_times: 2
    heartbeat_interval: 2.0
"""
from __future__ import annotations

import os
import shlex
import subprocess
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from .coordinator import CoordinatorServer

ENV_COORD = "HETU_TPU_COORDINATOR"
ENV_RANK = "HETU_TPU_WORKER_RANK"
ENV_NUM_WORKERS = "HETU_TPU_NUM_WORKERS"


@dataclass
class HostSpec:
    addr: str = "localhost"
    initial_workers: int = 1
    min_workers: int = 0
    max_workers: int = 8


def load_hostfile(path: str) -> Dict[str, Any]:
    import yaml
    with open(path) as f:
        cfg = yaml.safe_load(f)
    hosts = [HostSpec(**h) for h in cfg.get("hosts", [])]
    return {"hosts": hosts,
            "max_restart_times": int(cfg.get("max_restart_times", 0)),
            "heartbeat_interval": float(cfg.get("heartbeat_interval", 2.0))}


@dataclass
class _Worker:
    rank: int
    host: str
    proc: subprocess.Popen
    restarts: int = 0


class Launcher:
    """Spawn N workers running ``cmd`` and babysit them.

    ``cmd`` is a list (argv) executed with env vars ``HETU_TPU_COORDINATOR``
    (host:port of the coordinator), ``HETU_TPU_WORKER_RANK`` and
    ``HETU_TPU_NUM_WORKERS`` — the worker connects back via
    :class:`CoordinatorClient` and heartbeats.
    """

    def __init__(self, cmd: Sequence[str],
                 hosts: Optional[Sequence[HostSpec]] = None,
                 num_workers: Optional[int] = None,
                 max_restart_times: int = 0,
                 heartbeat_interval: float = 2.0,
                 heartbeat_ttl: float = 10.0,
                 env: Optional[Dict[str, str]] = None):
        if hosts is None:
            hosts = [HostSpec(addr="localhost",
                              initial_workers=num_workers or 1)]
        self.cmd = list(cmd)
        self.hosts = list(hosts)
        self.num_workers = sum(h.initial_workers for h in self.hosts)
        self.max_restart_times = max_restart_times
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_ttl = heartbeat_ttl
        self.extra_env = dict(env or {})
        self.server = CoordinatorServer(world_size=self.num_workers)
        self.workers: List[_Worker] = []
        self.events: List[Dict[str, Any]] = []   # monitor log (tests/obs)

    # -- spawning ------------------------------------------------------------

    def _worker_env(self, rank: int) -> Dict[str, str]:
        return {**self.extra_env,
                ENV_COORD: self.server.address,
                ENV_RANK: str(rank),
                ENV_NUM_WORKERS: str(self.num_workers)}

    def _spawn(self, rank: int, host: str) -> subprocess.Popen:
        wenv = self._worker_env(rank)
        if host in ("localhost", "127.0.0.1"):
            return subprocess.Popen(self.cmd, env={**os.environ, **wenv})
        # remote: ssh with env inlined (reference pssh path)
        env_str = " ".join(f"{k}={shlex.quote(v)}" for k, v in wenv.items())
        remote = f"{env_str} {' '.join(shlex.quote(c) for c in self.cmd)}"
        return subprocess.Popen(["ssh", "-o", "BatchMode=yes", host, remote])

    def start(self) -> "Launcher":
        self.server.start()
        rank = 0
        for h in self.hosts:
            for _ in range(h.initial_workers):
                self.workers.append(
                    _Worker(rank, h.addr, self._spawn(rank, h.addr)))
                rank += 1
        return self

    # -- monitoring (reference heartbeat monitor + max_restart_times) -------

    def monitor(self, poll: float = 0.5,
                timeout: Optional[float] = None) -> int:
        """Babysit until all workers exit (or timeout).  Dead processes are
        restarted while restart budget remains; returns the number of
        workers that completed cleanly."""
        t0 = time.time()
        done: Dict[int, int] = {}
        while len(done) < len(self.workers):
            for w in self.workers:
                if w.rank in done:
                    continue
                rc = w.proc.poll()
                if rc is None:
                    continue
                if rc == 0:
                    done[w.rank] = 0
                    continue
                if w.restarts < self.max_restart_times:
                    w.restarts += 1
                    self.events.append({"event": "restart", "rank": w.rank,
                                        "attempt": w.restarts, "rc": rc})
                    w.proc = self._spawn(w.rank, w.host)
                else:
                    done[w.rank] = rc
                    self.events.append({"event": "gave_up", "rank": w.rank,
                                        "rc": rc})
            # a hung worker (heartbeat-dead but process alive) must be
            # killed so the rc-based restart logic above engages
            dead = set(self.server.dead_ranks(ttl=self.heartbeat_ttl))
            for w in self.workers:
                if w.rank in dead and w.rank not in done \
                        and w.proc.poll() is None:
                    self.events.append({"event": "heartbeat_lost",
                                        "rank": w.rank})
                    w.proc.terminate()
            if timeout is not None and time.time() - t0 > timeout:
                self.terminate()
                raise TimeoutError("launcher monitor timed out")
            time.sleep(poll)
        return sum(1 for rc in done.values() if rc == 0)

    def terminate(self) -> None:
        for w in self.workers:
            if w.proc.poll() is None:
                w.proc.terminate()
        for w in self.workers:
            try:
                w.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                w.proc.kill()

    def shutdown(self) -> None:
        self.terminate()
        self.server.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()


def worker_client():
    """Inside a launched worker: connect back to the coordinator using the
    env the launcher set (reference worker-side CommGroup_Init path)."""
    from .coordinator import CoordinatorClient
    addr = os.environ[ENV_COORD]
    rank = os.environ.get(ENV_RANK, "0")
    c = CoordinatorClient(addr, uid=f"worker-{rank}")
    c.connect()
    c.start_heartbeat_thread()
    return c
