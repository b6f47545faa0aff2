"""One serving replica: an Engine wrapped as a process-local "host"
(port of ``hetu_tpu.serving.cluster.replica``).

Every replica registers with the cluster's ``rpc.CoordinatorServer`` as
a training worker would (connect -> rank, background heartbeat), so the
liveness machinery that detects a dead host detects a dead serving
replica: the cluster polls ``dead_ranks`` and re-routes a dead
replica's unfinished requests to survivors.  The control-plane protocol,
the placement policy and the page-handoff pricing are all real; only the
engines share one process (and, on the card, one device, one set of
weights and one compiled step).

Each replica exports:

* a **prefix-cache digest** (content-chained 64-bit page hashes,
  :meth:`PrefixCache.digest`): the router's placement key;
* **load facts**: outstanding tokens (remaining prefill + decode) and
  queue depth, for least-loaded placement and backpressure;
* its engine's metrics and trace planes, namespaced per replica by the
  cluster (``r{i}/...`` tracks, ``replica="r{i}"`` Prometheus label).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..engine import Engine
from ..request import RUNNING

#: replica roles — ``unified`` serves prefill+decode (replicated mode);
#: disaggregated clusters split into dedicated ``prefill`` and
#: ``decode`` groups with KV pages streamed between them
UNIFIED = "unified"
PREFILL = "prefill"
DECODE = "decode"


class Replica:
    """An engine + its coordinator identity + liveness state."""

    def __init__(self, idx: int, engine: Engine, role: str = UNIFIED,
                 client=None, heartbeat_interval: float = 0.5):
        self.idx = int(idx)
        self.engine = engine
        self.role = role
        self.client = client
        self.rank: Optional[int] = None
        self._hb_stop = None
        self._hb_interval = float(heartbeat_interval)
        # chaos straggler window: the cluster skips this replica's
        # engine beats while its step counter is below slow_until
        self.slow_until: float = 0.0
        # ``alive`` is the cluster's health VERDICT (flipped by the
        # coordinator's missed-heartbeat detection, or directly when no
        # coordinator runs); ``serving`` is the simulated process state
        # — kill() stops serving immediately, but with a coordinator
        # the verdict only lands once the TTL lapses, exactly like a
        # real crash
        self.alive = True
        self.serving = True
        # autoscaler drain intent: a draining replica serves what it
        # already owns but takes no new placements (router skips it);
        # once empty the controller fences it through kill()
        self.draining = False
        self._digest = None      # (cache version, digest) memo
        if client is not None:
            self.rank = client.connect()
            self._hb_stop = client.start_heartbeat_thread(
                interval=heartbeat_interval)

    # -- placement facts -----------------------------------------------------

    def digest(self) -> Dict[int, int]:
        """The live prefix-cache digest ({chain_hash: pages}); empty
        when the engine runs cache-off.  Memoized on the cache's
        version stamp — the router probes every replica per placement,
        and the tree only re-hashes when the cache actually changed."""
        pc = self.engine.prefix_cache
        if pc is None:
            return {}
        ver = pc.version
        if self._digest is None or self._digest[0] != ver:
            self._digest = (ver, pc.digest())
        return self._digest[1]

    def outstanding_tokens(self) -> int:
        """Token-work this replica still owes: remaining prefill +
        remaining decode over its queue and running set — the
        least-loaded placement metric (a queue of long prompts weighs
        more than the same count of short ones)."""
        total = 0
        for req in self._all_requests():
            total += max(0, len(req.tokens) - req.pos)         # prefill
            total += max(0, req.max_new_tokens - req.n_generated)
        return total

    def queue_depth(self) -> int:
        """Requests on this replica (queued + running) — the
        backpressure gate's unit."""
        return len(self.engine.queue) + len(self.engine.running)

    def _all_requests(self) -> List:
        out = list(self.engine.queue.requests())
        out.extend(r for r in self.engine.running if r.state == RUNNING)
        return out

    # -- liveness ------------------------------------------------------------

    def kill(self) -> None:
        """Simulate a replica crash: heartbeats and serving stop NOW;
        the death *verdict* arrives through the coordinator once the
        heartbeat TTL lapses (the cluster then re-routes this replica's
        unfinished requests) — the same two-step reality a crashed
        remote host has.  Without a coordinator the cluster detects the
        stopped ``serving`` flag directly."""
        if self._hb_stop is not None:
            self._hb_stop.set()
        self.serving = False

    def pause_heartbeat(self) -> None:
        """The zombie seam: heartbeats stall while the engine keeps
        stepping — the coordinator's TTL verdict will land even though
        the 'process' is alive, and the cluster must fence it."""
        if self._hb_stop is not None:
            self._hb_stop.set()
            self._hb_stop = None

    def resume_heartbeat(self) -> None:
        """A zombie's heartbeats return.  Deliberately does NOT clear
        the quarantine: a replica the cluster already declared dead
        stays fenced until :meth:`EngineCluster.readmit_replica` — a
        revived replica racing its own replacement is the
        double-delivery hazard the fence exists for."""
        if self.client is not None and self._hb_stop is None:
            self._hb_stop = self.client.start_heartbeat_thread(
                interval=self._hb_interval)
            try:
                self.client.heartbeat()   # refresh the verdict input NOW
            except Exception:
                pass

    def resurrect(self) -> None:
        """Operator re-admission (the cluster aborts the stale engine
        state first): serving and heartbeats restart, the liveness
        verdict resets."""
        self.serving = True
        self.alive = True
        self.draining = False
        self.slow_until = 0.0
        self.resume_heartbeat()

    def close(self) -> None:
        if self._hb_stop is not None:
            self._hb_stop.set()
        if self.client is not None:
            try:
                self.client.exit()
                self.client.close()
            except Exception:
                pass
