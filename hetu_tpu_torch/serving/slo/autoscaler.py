"""Replica autoscaler (port of ``hetu_tpu.serving.slo.autoscaler``, pure
Python): queue-depth + per-class TTFT signals driving the cluster's
existing replica lifecycle, with no second state machine.

Scale-**down** is a graceful drain: the victim replica gets its
``draining`` flag set (the router stops placing new work on it — see
:meth:`Router.candidates`), its in-flight requests finish where they
are (no recompute, no goodput dip), and only once it is empty does the
controller call :meth:`EngineCluster.kill_replica` — the same fencing
path a crash takes, so epochs, stale-completion drops and the chaos
invariants all hold without new machinery.  Scale-**up** is
:meth:`EngineCluster.readmit_replica` on a parked (previously drained
or dead) replica — the one sanctioned quarantine exit.

Signals are the router's: total backlog depth weighted toward
interactive, plus the cumulative interactive TTFT tail vs its SLO
target.  Two dampers keep a chaos-injected flap from thrashing the
fleet: a scale decision needs the signal to hold for
``hysteresis_steps`` CONSECUTIVE cluster steps, and after any action
the controller is silent for ``cooldown_steps``.

Composition with the fault plane: a replica that dies (chaos, fault
plan, operator kill) while the controller is draining it has its work
re-routed by the normal death sweep — the controller just clears its
drain intent and counts the capacity as already gone.  It never calls
``kill_replica`` on a dead replica, so a mid-drain crash can't
double-drain (asserted in tests/test_torch_slo.py).
"""
from __future__ import annotations

from typing import Optional

from .classes import DEFAULT_TARGETS


class Autoscaler:
    """Attach via ``EngineCluster(..., autoscaler=Autoscaler(...))``;
    the cluster calls :meth:`on_step` right after its health sweep."""

    def __init__(self, min_replicas: int = 1,
                 max_replicas: Optional[int] = None,
                 backlog_high: int = 8, backlog_low: int = 1,
                 ttft_target="default",
                 hysteresis_steps: int = 3, cooldown_steps: int = 20):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        self.min_replicas = int(min_replicas)
        self.max_replicas = None if max_replicas is None \
            else int(max_replicas)
        self.backlog_high = int(backlog_high)
        self.backlog_low = int(backlog_low)
        # "default" -> the interactive class's SLO target; None
        # disables the TTFT signal (queue depth only — synthetic-clock
        # tests, where wall-ratio targets are meaningless)
        self.ttft_target = DEFAULT_TARGETS["interactive"]["ttft_s"] \
            if ttft_target == "default" else \
            (None if ttft_target is None else float(ttft_target))
        self.hysteresis_steps = int(hysteresis_steps)
        self.cooldown_steps = int(cooldown_steps)
        # controller state
        self._over = 0           # consecutive steps of high pressure
        self._under = 0          # consecutive steps of idle fleet
        self._last_action: Optional[int] = None
        self._draining: set = set()      # replica idx with drain intent
        self._parked: list = []          # idxs WE scaled down (LIFO)
        # lifetime event counts (the cluster's counters mirror these)
        self.scale_up_events = 0
        self.scale_down_events = 0

    # -- the per-step controller ----------------------------------------------

    def on_step(self, cluster, step: int, now: float) -> None:
        self._finish_drains(cluster, now)
        # serving matters too: a replica we just fenced keeps its stale
        # alive=True until the next health sweep's verdict — it is not
        # capacity, and counting it could drain below min_replicas
        active = [r for r in cluster.replicas
                  if r.alive and r.serving and not r.draining]
        pressure, breach = self._signals(cluster, now)
        in_cooldown = self._last_action is not None \
            and step - self._last_action < self.cooldown_steps
        up = pressure >= self.backlog_high or breach
        down = pressure <= self.backlog_low and not breach
        if in_cooldown:
            self._over = self._under = 0
            return
        self._over = self._over + 1 if up else 0
        self._under = self._under + 1 if down else 0
        if self._over >= self.hysteresis_steps:
            if self._scale_up(cluster, step, now):
                self._last_action = step
            self._over = 0
        elif self._under >= self.hysteresis_steps:
            if len(active) > self.min_replicas \
                    and self._scale_down(cluster, active, step, now):
                self._last_action = step
            self._under = 0

    def _signals(self, cluster, now: float):
        # arrival-gated: a future-dated arrival is scheduled traffic,
        # not pressure — counting it would hold capacity through every
        # trough of a diurnal trace and the fleet would never scale down
        by_class = cluster._backlog.depth_by_class(now)
        # interactive waiters weigh double: one queued interactive
        # request is already a TTFT incident in the making
        pressure = sum(by_class.values()) \
            + by_class.get("interactive", 0)
        h = cluster.histograms.get("ttft_interactive")
        breach = bool(self.ttft_target is not None and h is not None
                      and h.count > 0
                      and h.percentile(90) > self.ttft_target)
        return pressure, breach

    # -- scale up: readmit a parked replica -----------------------------------

    def _scale_up(self, cluster, step: int, now: float) -> bool:
        active = sum(1 for r in cluster.replicas
                     if r.alive and r.serving and not r.draining)
        if self.max_replicas is not None and active >= self.max_replicas:
            return False
        # prefer a replica this controller drained (clean park), else
        # any dead one (capacity is capacity); never a draining one
        idx = None
        while self._parked:
            cand = self._parked.pop()
            if not cluster.replicas[cand].alive:
                idx = cand
                break
        if idx is None:
            dead = [r.idx for r in cluster.replicas
                    if not r.alive and r.idx not in self._draining]
            if not dead:
                return False
            idx = dead[0]
        cluster.readmit_replica(idx)
        self.scale_up_events += 1
        cluster.counters["scale_ups"].inc()
        tr = cluster.tracer
        if tr.enabled:
            tr.instant("scale_up", track="router", ts=now,
                       replica=idx, step=step,
                       backlog=len(cluster._backlog))
        return True

    # -- scale down: drain, then fence ----------------------------------------

    def _scale_down(self, cluster, active, step: int,
                    now: float) -> bool:
        # least-loaded victim; in a disaggregated fleet never drain the
        # last live replica of a role (the mode needs both sides)
        def last_of_role(r):
            return sum(1 for o in active if o.role == r.role) <= 1
        cands = [r for r in active
                 if not (cluster.mode == "disaggregated"
                         and last_of_role(r))]
        if not cands:
            return False
        victim = min(cands, key=lambda r: (r.outstanding_tokens(),
                                           -r.idx))
        victim.draining = True
        self._draining.add(victim.idx)
        tr = cluster.tracer
        if tr.enabled:
            tr.instant("drain", track="router", ts=now,
                       replica=victim.idx, step=step,
                       outstanding_tokens=victim.outstanding_tokens())
        return True

    def _finish_drains(self, cluster, now: float) -> None:
        for idx in list(self._draining):
            r = cluster.replicas[idx]
            if not r.alive:
                # died mid-drain (chaos/fault plan): the death sweep
                # already re-routed its work and fenced its epoch — the
                # capacity is gone, just clear the intent.  NOT a
                # second kill: that would double-drain
                self._draining.discard(idx)
                r.draining = False
                self._parked.append(idx)
                self._count_down(cluster, idx, now, reason="died")
                continue
            busy = r.engine.has_work \
                or any(k[0] == idx for k in cluster._placed)
            if not busy and any(h.get("dst") == idx
                                for h in cluster._pending_handoffs):
                # a chaos-delayed handoff is IN FLIGHT to this replica
                # (destination pinned, pages reserved): the engine looks
                # idle and nothing is placed yet, but fencing it now
                # would kill the transfer mid-air and force a restage —
                # breaking the graceful-drain contract ("in-flight
                # requests finish where they are"); defer until the
                # handoff lands or re-routes
                cluster.counters["drains_deferred_inflight"].inc()
                busy = True
            if busy:
                continue
            r.draining = False
            self._draining.discard(idx)
            self._parked.append(idx)
            cluster.kill_replica(idx)
            self._count_down(cluster, idx, now, reason="drained")

    def _count_down(self, cluster, idx: int, now: float,
                    reason: str) -> None:
        self.scale_down_events += 1
        cluster.counters["scale_downs"].inc()
        tr = cluster.tracer
        if tr.enabled:
            tr.instant("scale_down", track="router", ts=now,
                       replica=idx, reason=reason)
