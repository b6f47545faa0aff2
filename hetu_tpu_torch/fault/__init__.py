"""Fault plane (port of ``hetu_tpu.fault``): deterministic chaos
injection + fenced recovery for the serving cluster.

A seeded :class:`FaultPlan` schedules replica crashes, zombies
(heartbeat stall while the engine keeps stepping), handoff transport
drops/duplicates/delays, coordinator refusals and stragglers; a
:class:`ChaosController` injects them at the serving cluster's seams;
and the recovery machinery (fencing epochs, capped-exponential retry
with deadlines (:class:`RetryPolicy`), destination-death re-staging,
load shedding) keeps every invariant: no request lost, no duplicated
token, temperature-0 outputs equal to the fault-free run.
"""
from .backoff import RetryPolicy, unit_hash
from .chaos import ChaosController, check_cluster_invariants, cluster_problems
from .plan import (EVENT_KINDS, NUMERIC_KINDS, TRAINING_KINDS,
                   TRANSPORT_KINDS, FaultEvent, FaultPlan)

__all__ = [
    "ChaosController", "EVENT_KINDS", "FaultEvent", "FaultPlan",
    "NUMERIC_KINDS", "RetryPolicy", "TRAINING_KINDS",
    "TRANSPORT_KINDS", "check_cluster_invariants", "cluster_problems",
    "unit_hash",
]
