"""Deterministic, seeded chaos schedules (port of
``hetu_tpu.fault.plan``: the same seed gives the same plan).

A :class:`FaultPlan` is the whole experiment: a sorted list of
:class:`FaultEvent`\\ s keyed by **step index** (cluster steps for
serving, trainer steps for training) plus a map of **transport
verdicts** keyed by handoff-attempt ordinal.  Both keys are
deterministic under the repo's synthetic clocks, so the same plan
replays the same failure sequence bit-for-bit — which is what lets the
chaos tests assert temp-0 output equality against the fault-free run.

Event kinds (serving cluster seams, ``fault/chaos.py``):

``crash``        the replica process dies: serving and heartbeats stop
                 NOW; the death *verdict* lands via the coordinator TTL
                 (or immediately without one) and the cluster re-routes.
``zombie``       heartbeats stall while the engine keeps stepping — the
                 cluster must fence it: its late completions are stale.
``revive``       a zombie's heartbeats resume.  The replica stays
                 QUARANTINED (the TTL verdict is sticky) until an
                 explicit ``readmit`` — a revived replica racing its own
                 replacement is exactly the double-delivery hazard the
                 fencing epochs exist for.
``readmit``      explicit operator re-admission: the replica's stale
                 engine state is aborted, heartbeats restart, and it
                 rejoins the candidate set under the current fence
                 epoch.
``straggler``    the replica slows down for ``duration`` steps (its
                 engine skips beats); load-aware placement routes
                 around it, nothing is lost.
``coord_refuse`` the coordinator refuses every op for ``duration``
                 seconds (real time — heartbeat threads live on wall
                 clocks); surviving it is the heartbeat thread's
                 backoff-retry contract.
``worker_death`` (training) a worker rank stops heartbeating; the
                 fault-tolerant trainer re-plans on survivors and
                 restores the last snapshot.

Numeric + durability verdicts (the SILENT failures —
injected by the fault-tolerant trainer at the sentry/checkpoint
seams of the JAX package's ``resilience/``; the port's
serving ``ChaosController`` refuses them):

``grad_nan``     the step's gradients go NaN (a silent compute
                 corruption); the on-device sentry must skip the
                 update with bitwise-zero residue.
``grad_spike``   the gradients blow up finite (norm past the sentry
                 threshold) — same skip contract.
``loss_spike``   the loss jumps past the relative EMA threshold; the
                 policy ladder rewinds to the last good checkpoint
                 generation.
``shard_corrupt`` bytes flip inside the newest checkpoint generation's
                 tensor shard (bit rot / torn write); the next verified
                 restore must fall back past it.
``kill_mid_write`` the checkpoint writer dies between shard files; the
                 partial generation never commits a manifest and the
                 previous generation still restores.

Transport verdicts (``FaultPlan.transport``): the N-th handoff
injection attempt (a global ordinal counted by the controller) gets
``("drop", 0)`` (the wire ate it — retry with backoff), ``("dup", 0)``
(delivered but the ack was lost — the sender re-delivers and the
``(request id, epoch)`` dedup must drop the duplicate) or
``("delay", k)`` (in flight for ``k`` clock units — the window where a
destination death forces re-staging).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: replica/worker-level event kinds
EVENT_KINDS = ("crash", "zombie", "revive", "readmit", "straggler",
               "coord_refuse", "worker_death",
               # silent-failure verdicts (numeric sentry + durable
               # checkpoint seams, resilience/ — trainer-injected)
               "grad_nan", "grad_spike", "loss_spike",
               "shard_corrupt", "kill_mid_write")
#: the subset the numeric sentry detects on-device
NUMERIC_KINDS = ("grad_nan", "grad_spike", "loss_spike")
#: training-plane kinds (injected by the fault-tolerant trainer; a
#: serving ChaosController must ignore them rather than index replicas)
TRAINING_KINDS = ("worker_death",) + NUMERIC_KINDS + (
    "shard_corrupt", "kill_mid_write")
#: handoff-wire verdict kinds
TRANSPORT_KINDS = ("drop", "dup", "delay")


@dataclass(frozen=True)
class FaultEvent:
    step: int
    kind: str
    target: int = -1
    duration: float = 0.0     # straggler steps / refuse seconds / delay
    ratio: float = 1.0        # straggler slowdown (training seam)

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"have {EVENT_KINDS}")


@dataclass
class FaultPlan:
    """A deterministic chaos schedule: replica events by step +
    transport verdicts by handoff-attempt ordinal."""

    events: List[FaultEvent] = field(default_factory=list)
    transport: Dict[int, Tuple[str, float]] = field(default_factory=dict)
    seed: int = 0

    def __post_init__(self):
        self.events = sorted(self.events, key=lambda e: (e.step, e.kind,
                                                         e.target))
        for k, v in self.transport.items():
            if v[0] not in TRANSPORT_KINDS:
                raise ValueError(f"unknown transport verdict {v!r} at "
                                 f"attempt {k}")

    def due(self, step: int) -> List[FaultEvent]:
        return [e for e in self.events if e.step == int(step)]

    def transport_verdict(self, ordinal: int
                          ) -> Optional[Tuple[str, float]]:
        return self.transport.get(int(ordinal))

    @property
    def n_events(self) -> int:
        return len(self.events) + len(self.transport)

    def describe(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        for v, _ in self.transport.values():
            k = f"transport_{v}"
            out[k] = out.get(k, 0) + 1
        return out

    # -- seeded generation ---------------------------------------------------

    @classmethod
    def random(cls, seed: int, num_replicas: int, steps: int,
               n_events: int = 50,
               protect: Sequence[int] = (),
               kinds: Sequence[str] = ("crash", "zombie", "revive",
                                       "readmit", "straggler"),
               transport_kinds: Sequence[str] = TRANSPORT_KINDS,
               transport_every: int = 3) -> "FaultPlan":
        """A seeded random schedule that is always *survivable*: the
        generator tracks the simulated alive set and never crashes or
        zombifies the last live replica (``protect`` pins extra indices
        as never-faulted).  Roughly one in ``transport_every`` of the
        budgeted events becomes a transport verdict instead of a
        replica event."""
        rng = np.random.RandomState(seed)
        alive = set(range(num_replicas))
        down: Dict[int, int] = {}   # crashed/zombie -> step it went down
        events: List[FaultEvent] = []
        transport: Dict[int, Tuple[str, float]] = {}
        next_attempt = 0
        # the generated timeline is MONOTONIC in step, so the alive-set
        # tracking below replays in exactly the order the cluster will
        # apply events — the >=1-alive guarantee is exact, not a
        # generation-order approximation
        cur = 1
        readmit_steps: set = set()
        for _ in range(n_events):
            # advance within the run horizon: events past `steps` would
            # never be injected (revive/readmit ordering jumps below
            # may still exceed it — correctness beats the cap there)
            if cur < steps:
                cur += int(rng.randint(0, 2))
            if transport_kinds and rng.randint(transport_every) == 0:
                v = transport_kinds[rng.randint(len(transport_kinds))]
                dur = float(rng.randint(1, 4)) if v == "delay" else 0.0
                next_attempt += int(rng.randint(1, 5))
                transport[next_attempt] = (v, dur)
                continue
            kind = kinds[rng.randint(len(kinds))]
            if kind in ("crash", "zombie"):
                # never share a step with a readmit: the guarantee that
                # >=1 replica stays alive must hold at every point of
                # the step-sorted replay, not just between steps
                while cur in readmit_steps:
                    cur += 1
                cands = sorted(r for r in alive if r not in protect)
                if len(alive) <= 1 or not cands:
                    continue
                t = cands[rng.randint(len(cands))]
                alive.discard(t)
                down[t] = cur
                events.append(FaultEvent(cur, kind, t))
            elif kind in ("revive", "readmit"):
                if not down:
                    continue
                t = sorted(down)[rng.randint(len(down))]
                if down[t] >= cur:
                    # never the same step as the fault that downed the
                    # target: the death verdict must land first
                    cur = down[t] + 1
                if kind == "readmit":
                    del down[t]
                    alive.add(t)
                    readmit_steps.add(cur)
                events.append(FaultEvent(cur, kind, t))
            elif kind == "straggler":
                t = int(rng.randint(num_replicas))
                events.append(FaultEvent(cur, kind, t,
                                         duration=float(
                                             rng.randint(1, 6)),
                                         ratio=2.0))
        return cls(events=events, transport=transport, seed=seed)
