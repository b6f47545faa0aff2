"""The chaos controller: injects a FaultPlan at the cluster's seams
(port of ``hetu_tpu.fault.chaos``).

``EngineCluster(chaos=ChaosController(plan))`` wires the controller
into the serving loop: at the top of every cluster step the controller
applies the events due at that step (crash / zombie / revive / readmit
/ straggler / coordinator refusal), and every handoff injection attempt
asks it for a transport verdict (drop / dup / delay).  Every injected
fault emits a ``fault`` instant on the ``chaos`` tracer track, and the
cluster's recovery machinery emits its own instants (``replica_dead``,
``reroute``, ``handoff_retry``, ``handoff_restaged``,
``duplicate_dropped``, ``stale_completion_dropped``, ``shed``,
``replica_readmitted``), so one trace shows fail -> detect -> recover.

The controller owns no RNG (all randomness lives in the seeded
:class:`~hetu_tpu_torch.fault.plan.FaultPlan`) and the transport-attempt
ordinal is a plain counter, so replaying a plan against a trace injects
the same faults at the same instants.  The training-plane kinds
(``TRAINING_KINDS``) are consumed only by the fault-tolerant trainer
(``elastic.FaultTolerantTrainer``): a serving controller records them in
its trace and audit log and ignores them, as the JAX package's does.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from .plan import TRAINING_KINDS, FaultEvent, FaultPlan


class ChaosController:
    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.injected: List[Dict[str, Any]] = []   # audit log
        self._attempts = 0                         # handoff ordinal
        self._applied: set = set()                 # event identity guard

    # -- cluster seam --------------------------------------------------------

    def on_step(self, cluster, step: int, now: float) -> None:
        """Apply every event due at ``step`` to the cluster."""
        for ev in self.plan.due(step):
            key = (ev.step, ev.kind, ev.target)
            if key in self._applied:
                continue
            self._applied.add(key)
            self._apply(cluster, ev, now)

    def _apply(self, cluster, ev: FaultEvent, now: float) -> None:
        tr = cluster.tracer
        if tr.enabled:
            tr.instant("fault", track="chaos", ts=now, kind=ev.kind,
                       target=ev.target, step=ev.step,
                       duration=ev.duration)
        # lazy import: fault <-> serving would cycle at module level
        from ..serving.kv_pool import protocol_seq
        self.injected.append({"step": ev.step, "kind": ev.kind,
                              "target": ev.target, "ts": now,
                              "seq": protocol_seq()})
        if ev.kind == "coord_refuse":
            if cluster.server is not None:
                cluster.server.refuse_for(float(ev.duration))
            return
        if ev.kind in TRAINING_KINDS:
            # training-plane events (worker death, numeric sentry,
            # checkpoint durability) reaching a serving cluster are a
            # plan-authoring error; ignored rather than corrupt state
            # (elastic.FaultTolerantTrainer consumes them)
            return
        r = cluster.replicas[ev.target]
        if ev.kind == "crash":
            # without a coordinator the cluster's health sweep reads the
            # stopped ``serving`` flag at the next step
            r.kill()
        elif ev.kind == "zombie":
            # heartbeats stall, the engine keeps stepping.  With a
            # coordinator the TTL verdict lands on real time; without
            # one the verdict lands now (the health sweep reads
            # ``not alive`` and fences the replica)
            r.pause_heartbeat()
            if cluster.server is None:
                r.alive = False
        elif ev.kind == "revive":
            # heartbeats return; quarantine stays until an explicit
            # readmit
            r.resume_heartbeat()
        elif ev.kind == "readmit":
            cluster.readmit_replica(ev.target)
        elif ev.kind == "straggler":
            r.slow_until = cluster.steps + max(1.0, float(ev.duration))

    # -- transport seam ------------------------------------------------------

    def handoff_verdict(self) -> Tuple[str, float]:
        """The verdict for the NEXT handoff injection attempt; consumes
        one ordinal.  ``("ok", 0)`` when the plan says nothing."""
        v = self.plan.transport_verdict(self._attempts)
        self._attempts += 1
        return v if v is not None else ("ok", 0.0)


def cluster_problems(cluster) -> List[str]:
    """Cluster request-accounting invariants (the port's copy of the
    JAX package's ``analysis.protocol.cluster_problems``, which depends
    on no framework): every request lives in exactly one home (backlog /
    live / finished / shed), finished and shed are disjoint, token
    budgets hold."""
    problems: List[str] = []
    backlog_ids = {rid for _, rid, _ in cluster._backlog}
    placed_ids = {creq.req_id
                  for (creq, _stage, _epoch) in cluster._placed.values()}
    handoff_ids = {h["creq"].req_id for h in cluster._pending_handoffs
                   if not h.get("redelivery")}
    finished_ids = set(cluster.finished)
    shed_ids = set(cluster.shed)
    if finished_ids & shed_ids:
        problems.append(f"requests both finished and shed: "
                        f"{finished_ids & shed_ids}")
    for rid, creq in cluster.requests.items():
        homes = [rid in backlog_ids,
                 rid in finished_ids,
                 rid in shed_ids,
                 rid in placed_ids or rid in handoff_ids]
        if sum(bool(h) for h in homes) != 1:
            problems.append(
                f"request {rid} accounting broken: backlog={homes[0]} "
                f"finished={homes[1]} shed={homes[2]} live={homes[3]} "
                f"(stage={creq.stage!r}, "
                f"pending={creq.handoff_pending})")
        if len(creq.out_tokens) > creq.max_new_tokens:
            problems.append(f"request {rid} overran its budget "
                            f"(duplicated tokens?)")
    return problems


def check_cluster_invariants(cluster) -> None:
    """The chaos-fuzz safety net, asserted after EVERY step: request
    accounting is exact (:func:`cluster_problems`), and every live pool's
    own invariants hold."""
    problems = cluster_problems(cluster)
    assert not problems, "; ".join(problems)
    for r in cluster.replicas:
        if r.serving and r.engine.debug:
            r.engine.pool.check_invariants()
            if r.engine.prefix_cache is not None:
                r.engine.prefix_cache.check_invariants()
