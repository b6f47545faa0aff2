"""The port's fault plane on the CPU: the cluster half of the JAX
package's ``tests/test_fault.py`` one for one, the port against the JAX
package, and the coordinator on a real clock.

The weights are built by the JAX model from seed 3 and carried across
with ``state_from_numpy`` (vocab 97, hidden 32, 2 layers, fp32); the JAX
suite's ``SHAPE_KW``, a synthetic clock and ``coordinator=False``.

- One for one: the retry policy's cap and determinism, seeded plans
  survivable and deterministic, unknown kinds refused; a crash (with the
  fail -> detect -> recover trace), a fenced zombie, the revival race;
  transport drops retried with backoff, duplicates deduplicated by
  (request, epoch), a destination death re-staged, an empty decode fleet
  degrading to monolithic serving; shedding past the deadline, the
  bounded backlog; the seeded ~300-event fuzz and the chaos smoke gate.
  Every chaos run's tokens equal the fault-free run's.  The
  ``unfenced-handoff`` rule test waits for the analysis plane (ROADMAP
  queue 1 item 18).
- Against JAX: ``FaultPlan.random`` and ``RetryPolicy`` delays for
  seeds 0-4 equal; the chaos smoke gate's plan gives equal tokens,
  counters, injected faults, protocol events and handoff records.
- The coordinator: a localhost server and two clients, heartbeat-driven
  health under a short real TTL (the one test here that waits on a wall
  clock, a few seconds at most); training-plane faults refused.
"""
import time

import numpy as np
import pytest

import hetu_tpu as jht
from hetu_tpu.fault import ChaosController as JaxChaos
from hetu_tpu.fault import FaultPlan as JaxFaultPlan
from hetu_tpu.fault import RetryPolicy as JaxRetryPolicy
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPTLMHeadModel
from hetu_tpu.planner.cost_model import ChipSpec as JaxChipSpec
from hetu_tpu.planner.cost_model import ClusterSpec as JaxClusterSpec
from hetu_tpu.serving import EngineCluster as JaxEngineCluster
from hetu_tpu.serving.cluster import LocalPageTransport as JaxTransport
from hetu_tpu_torch.fault import (ChaosController, FaultEvent, FaultPlan,
                                  RetryPolicy, check_cluster_invariants)
from hetu_tpu_torch.models import GPTConfig
from hetu_tpu_torch.models.convert import state_from_numpy
from hetu_tpu_torch.models.generate import generate
from hetu_tpu_torch.obs.tracer import SpanTracer
from hetu_tpu_torch.planner.cost_model import ChipSpec, ClusterSpec
from hetu_tpu_torch.rpc import CoordinatorClient, CoordinatorServer
from hetu_tpu_torch.serving import EngineCluster
from hetu_tpu_torch.serving.cluster import LocalPageTransport
from hetu_tpu_torch.serving.decode import build_unified_step_fn

CFG_KW = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=64, sp=False, dropout=0.0)
SHAPE_KW = dict(page_size=8, max_batch=4, chunk_size=8, prefill_rows=1,
                max_model_len=56)
SPEC_NUMBERS = dict(name="parity", peak_flops=1e15, hbm_bytes=8e10,
                    hbm_bw=3e12, ici_bw=2e11, ici_links=4,
                    ici_latency=2e-6, dcn_bw=2.5e10, dcn_latency=1e-5)


@pytest.fixture(scope="module")
def model_state():
    jht.set_seed(3)
    with jht.graph("eager", create_new=True):
        model = JaxGPTLMHeadModel(JaxGPTConfig(**CFG_KW))
        model.logits(np.zeros((1, 4), np.int32))
        jstate = {k: np.asarray(v) for k, v in model.state_dict().items()}
    cfg = GPTConfig(**CFG_KW)
    return state_from_numpy(jstate, cfg, device="cpu"), cfg, jstate


@pytest.fixture(scope="module")
def shared_fn():
    return build_unified_step_fn(
        GPTConfig(**CFG_KW), SHAPE_KW["max_batch"], SHAPE_KW["chunk_size"],
        SHAPE_KW["prefill_rows"],
        -(-SHAPE_KW["max_model_len"] // SHAPE_KW["page_size"]),
        SHAPE_KW["page_size"], device="cpu")


def _make_cluster(state, cfg, fn=None, cls=EngineCluster, **kw):
    clock = [0.0]
    kw.setdefault("time_fn", lambda: clock[0])
    kw.setdefault("num_pages", 12)
    for k, v in SHAPE_KW.items():
        kw.setdefault(k, v)
    kw.setdefault("debug", True)
    kw.setdefault("ttl", 3600.0)
    kw.setdefault("coordinator", False)
    if cls is EngineCluster:
        kw.setdefault("device", "cpu")
    else:
        kw.setdefault("use_kernel", False)
    cl = cls(state, cfg, step_fn=fn, **kw)
    cl._test_clock = clock
    return cl


def _drain(cl, limit=800, invariants=False):
    n = 0
    while cl.has_work:
        cl.step()
        if invariants:
            check_cluster_invariants(cl)
        cl._test_clock[0] += 1.0
        n += 1
        assert n < limit, "cluster did not drain"
    return n


def _trace(rng, n, vocab=97, lo=8, hi=20):
    return [rng.randint(1, vocab, size=rng.randint(lo, hi)).tolist()
            for _ in range(n)]


def _fault_free(state, cfg, fn, prompts, new, name, **kw):
    """The reference outputs every chaos run must reproduce."""
    cl = _make_cluster(state, cfg, fn, name=name, **kw)
    for i, p in enumerate(prompts):
        cl.add_request(p, new, arrival_time=float(i))
    _drain(cl)
    out = {rid: list(c.out_tokens) for rid, c in cl.finished.items()}
    cl.close()
    return out


def _solo(state, cfg, prompt, n_new):
    return generate(state, cfg, [prompt], n_new,
                    device="cpu")[0, len(prompt):].tolist()


DISAGG = dict(num_replicas=3, mode="disaggregated", num_prefill=1)


def _disagg(state, cfg, fn, name, plan=None, n=3, **kw):
    chaos = ChaosController(plan) if plan is not None else None
    return _make_cluster(state, cfg, fn, num_replicas=n,
                         mode="disaggregated", num_prefill=1,
                         name=name, chaos=chaos, **kw)


# ---------------------------------------------------------------------------
# policy / plan units
# ---------------------------------------------------------------------------


def test_retry_policy_caps_and_is_deterministic():
    p = RetryPolicy(base=0.5, cap=4.0, jitter=0.25, deadline=10.0)
    d = [p.delay(a, key=7) for a in range(10)]
    assert d == [p.delay(a, key=7) for a in range(10)]
    assert max(d) <= 4.0 * 1.25 + 1e-9
    assert d[0] <= 0.5 * 1.25 + 1e-9
    assert d[5] > d[0]
    assert [p.delay(a, key=8) for a in range(10)] != d
    assert p.deadline_for(2.0) == 12.0
    assert not p.expired(2.0, 11.0) and p.expired(2.0, 12.5)
    assert RetryPolicy(deadline=None).deadline_for(2.0) is None


def test_fault_plan_random_is_survivable_and_deterministic():
    for seed in range(6):
        plan = FaultPlan.random(seed, num_replicas=3, steps=50,
                                n_events=80)
        alive = {0, 1, 2}
        for ev in plan.events:
            if ev.kind in ("crash", "zombie"):
                alive.discard(ev.target)
            elif ev.kind == "readmit":
                alive.add(ev.target)
            assert alive, f"plan {seed} killed every replica"
    a = FaultPlan.random(3, 3, 50, n_events=40)
    b = FaultPlan.random(3, 3, 50, n_events=40)
    assert a.events == b.events and a.transport == b.transport
    assert FaultPlan.random(4, 3, 50, n_events=40).events != a.events


def test_fault_plan_rejects_unknown_kinds():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultEvent(0, "meteor", 0)
    with pytest.raises(ValueError, match="unknown transport verdict"):
        FaultPlan(transport={0: ("teleport", 0.0)})


@pytest.mark.parametrize("seed", range(5))
def test_plans_and_delays_match_jax(seed):
    """``FaultPlan.random`` (over a numpy ``RandomState``) and the retry
    delays (blake2b jitter) are the JAX package's, bit for bit."""
    for kw in (dict(num_replicas=3, steps=50, n_events=80),
               dict(num_replicas=4, steps=60, n_events=300,
                    protect=(0,))):
        got = FaultPlan.random(seed, **kw)
        want = JaxFaultPlan.random(seed, **kw)
        assert [(e.step, e.kind, e.target, e.duration, e.ratio)
                for e in got.events] == \
            [(e.step, e.kind, e.target, e.duration, e.ratio)
             for e in want.events]
        assert got.transport == want.transport
        assert got.describe() == want.describe()
    for pkw in (dict(), dict(base=0.25, cap=3.0, multiplier=3.0,
                             jitter=0.5)):
        p, j = RetryPolicy(**pkw), JaxRetryPolicy(**pkw)
        assert [p.delay(a, key=seed) for a in range(12)] == \
            [j.delay(a, key=seed) for a in range(12)]


# ---------------------------------------------------------------------------
# crash / zombie / revival race
# ---------------------------------------------------------------------------


def test_chaos_crash_bitforbit_and_trace(model_state, shared_fn):
    """A scheduled crash: the dead replica's work re-routes, outputs stay
    the fault-free run's, and the tracer shows fail -> detect ->
    recover."""
    state, cfg, _ = model_state
    rng = np.random.RandomState(0)
    prompts = _trace(rng, 6)
    NEW = 8
    want = _fault_free(state, cfg, shared_fn, prompts, NEW, "f_ref")
    plan = FaultPlan(events=[FaultEvent(step=3, kind="crash", target=1)])
    tracer = SpanTracer()
    cl = _make_cluster(state, cfg, shared_fn, num_replicas=2,
                       name="f_crash", policy="load",
                       chaos=ChaosController(plan), tracer=tracer)
    reqs = [cl.add_request(p, NEW, arrival_time=float(i))
            for i, p in enumerate(prompts)]
    _drain(cl, invariants=True)
    assert set(cl.finished) == {r.req_id for r in reqs}
    for r in reqs:
        assert r.out_tokens == want[r.req_id]
    ms = cl.metrics_summary()
    assert ms["replica_deaths"] == 1
    assert ms["requests_rerouted"] >= 1
    names = [e.name for e in tracer.events()]
    for evname in ("fault", "replica_dead", "reroute"):
        assert evname in names, f"missing {evname} instant"
    assert names.index("fault") < names.index("replica_dead") \
        < names.index("reroute")
    cl.close()


def test_chaos_zombie_fenced_no_duplicate_tokens(model_state, shared_fn):
    """The zombie keeps stepping after its heartbeats stall: the cluster
    fences it (late completions dropped, stream tokens ignored) and every
    request finishes once with fault-free outputs."""
    state, cfg, _ = model_state
    rng = np.random.RandomState(1)
    prompts = _trace(rng, 6)
    NEW = 8
    want = _fault_free(state, cfg, shared_fn, prompts, NEW, "f_zref")
    plan = FaultPlan(events=[FaultEvent(step=4, kind="zombie", target=1)])
    cl = _make_cluster(state, cfg, shared_fn, num_replicas=2,
                       name="f_zombie", policy="load",
                       chaos=ChaosController(plan))
    reqs = [cl.add_request(p, NEW, arrival_time=float(i))
            for i, p in enumerate(prompts)]
    _drain(cl, invariants=True)
    z = cl.replicas[1]
    assert z.serving and not z.alive, "zombie state lost"
    assert set(cl.finished) == {r.req_id for r in reqs}
    for r in reqs:
        assert r.out_tokens == want[r.req_id], \
            "zombie double-delivery corrupted a request"
        assert len(r.out_tokens) == NEW
    assert cl.metrics_summary()["stale_completions_dropped"] > 0
    cl.close()


def test_revived_replica_stays_quarantined_until_readmit(model_state,
                                                         shared_fn):
    """A TTL-expired replica that resumes heartbeating does not re-enter
    the candidate set by itself; after an explicit readmission it serves
    again under the new fence epoch."""
    state, cfg, _ = model_state
    plan = FaultPlan(events=[FaultEvent(step=2, kind="zombie", target=1),
                             FaultEvent(step=6, kind="revive", target=1)])
    cl = _make_cluster(state, cfg, shared_fn, num_replicas=2,
                       name="f_revive", policy="load",
                       chaos=ChaosController(plan))
    rng = np.random.RandomState(2)
    prompts = _trace(rng, 5)
    reqs = [cl.add_request(p, 6, arrival_time=float(i))
            for i, p in enumerate(prompts)]
    _drain(cl, invariants=True)
    assert not cl.replicas[1].alive, \
        "revived replica re-admitted itself (revival race)"
    assert set(cl.finished) == {r.req_id for r in reqs}
    fence_at_death = cl._fence[1]
    cl.readmit_replica(1)
    assert cl.replicas[1].alive
    assert not cl.replicas[1].engine.has_work, "stale work survived"
    assert cl.metrics_summary()["readmits"] == 1
    late = cl.add_request([4, 5, 6, 7], 4, arrival_time=cl._test_clock[0])
    _drain(cl, invariants=True)
    assert late.out_tokens == _solo(state, cfg, late.prompt, 4)
    assert cl._fence[1] == fence_at_death   # epoch advances on death only
    cl.close()


# ---------------------------------------------------------------------------
# transport chaos (disaggregated handoffs)
# ---------------------------------------------------------------------------


def test_transport_drop_retries_with_backoff(model_state, shared_fn):
    state, cfg, _ = model_state
    rng = np.random.RandomState(3)
    prompts = _trace(rng, 5)
    NEW = 8
    want = _fault_free(state, cfg, shared_fn, prompts, NEW, "f_dref",
                       **DISAGG)
    plan = FaultPlan(transport={0: ("drop", 0.0), 1: ("drop", 0.0)})
    cl = _disagg(state, cfg, shared_fn, "f_drop", plan)
    reqs = [cl.add_request(p, NEW, arrival_time=float(i))
            for i, p in enumerate(prompts)]
    _drain(cl, invariants=True)
    assert cl.metrics_summary()["handoff_retries"] >= 2
    assert set(cl.finished) == {r.req_id for r in reqs}
    for r in reqs:
        assert r.out_tokens == want[r.req_id]
    cl.close()


def test_transport_dup_deduped_by_request_epoch(model_state, shared_fn):
    """A delivery whose ack was lost is re-sent; the (request id,
    staging epoch) dedup drops the duplicate."""
    state, cfg, _ = model_state
    rng = np.random.RandomState(4)
    prompts = _trace(rng, 5)
    NEW = 8
    want = _fault_free(state, cfg, shared_fn, prompts, NEW, "f_dupref",
                       **DISAGG)
    plan = FaultPlan(transport={0: ("dup", 0.0), 2: ("dup", 0.0)})
    cl = _disagg(state, cfg, shared_fn, "f_dup", plan)
    reqs = [cl.add_request(p, NEW, arrival_time=float(i))
            for i, p in enumerate(prompts)]
    _drain(cl, invariants=True)
    assert cl.metrics_summary()["duplicate_deliveries_dropped"] >= 2
    assert set(cl.finished) == {r.req_id for r in reqs}
    for r in reqs:
        assert r.out_tokens == want[r.req_id]
        assert len(r.out_tokens) == NEW
    cl.close()


def test_destination_death_restages_handoff(model_state, shared_fn):
    """A delayed (in-flight) handoff whose pinned destination dies
    mid-transfer is re-staged to a surviving decode replica."""
    state, cfg, _ = model_state
    rng = np.random.RandomState(5)
    prompts = _trace(rng, 4)
    NEW = 8
    want = _fault_free(state, cfg, shared_fn, prompts, NEW, "f_rsref",
                       **DISAGG)
    plan = FaultPlan(
        events=[FaultEvent(step=3, kind="crash", target=1)],
        transport={i: ("delay", 3.0) for i in range(4)})
    cl = _disagg(state, cfg, shared_fn, "f_restage", plan)
    reqs = [cl.add_request(p, NEW, arrival_time=float(i))
            for i, p in enumerate(prompts)]
    _drain(cl, invariants=True)
    assert cl.metrics_summary()["handoffs_restaged"] >= 1, \
        "no destination death was in flight; test is vacuous"
    assert set(cl.finished) == {r.req_id for r in reqs}
    for r in reqs:
        assert r.out_tokens == want[r.req_id]
    cl.close()


def test_decode_fleet_empty_degrades_to_monolithic(model_state,
                                                   shared_fn):
    """Every decode replica dead: staged handoffs degrade to end-to-end
    serving on the survivors."""
    state, cfg, _ = model_state
    rng = np.random.RandomState(6)
    prompts = _trace(rng, 3)
    NEW = 6
    want = _fault_free(state, cfg, shared_fn, prompts, NEW, "f_mref")
    plan = FaultPlan(events=[FaultEvent(step=2, kind="crash", target=1)])
    cl = _disagg(state, cfg, shared_fn, "f_mono", plan, n=2)
    reqs = [cl.add_request(p, NEW, arrival_time=float(i))
            for i, p in enumerate(prompts)]
    _drain(cl, invariants=True)
    assert set(cl.finished) == {r.req_id for r in reqs}
    for r in reqs:
        assert r.out_tokens == want[r.req_id]
    assert cl.replicas[0].engine.metrics_summary()["tokens_generated"] \
        > len(prompts)
    cl.close()


# ---------------------------------------------------------------------------
# load shedding / bounded backlog
# ---------------------------------------------------------------------------


def test_load_shedding_past_deadline_is_retriable(model_state,
                                                  shared_fn):
    """Whole fleet backpressured past the deadline: the request is shed
    with a retriable rejection, and a later resubmission completes."""
    state, cfg, _ = model_state
    cl = _make_cluster(state, cfg, shared_fn, num_replicas=1,
                       name="f_shed", max_queue_depth=1,
                       request_deadline=3.0)
    long = cl.add_request(list(range(1, 17)), 12, arrival_time=0.0)
    waiters = [cl.add_request([30 + i, 2, 3], 4, arrival_time=0.0)
               for i in range(3)]
    _drain(cl, invariants=True)
    assert long.req_id in cl.finished
    shed = [w for w in waiters if w.rejected]
    assert shed, "no request was shed under saturation past deadline"
    for w in shed:
        assert w.reject_reason == "backpressured_past_deadline"
        assert w.req_id in cl.shed and w.req_id not in cl.finished
    assert cl.metrics_summary()["requests_shed"] == len(shed)
    assert set(cl.finished) | set(cl.shed) == \
        {r.req_id for r in [long] + waiters}
    retry = cl.add_request(shed[0].prompt, 4,
                           arrival_time=cl._test_clock[0])
    _drain(cl, invariants=True)
    assert retry.out_tokens == _solo(state, cfg, shed[0].prompt, 4)
    cl.close()


def test_bounded_backlog_sheds_at_front_door(model_state, shared_fn):
    state, cfg, _ = model_state
    cl = _make_cluster(state, cfg, shared_fn, num_replicas=1,
                       name="f_bound", max_backlog=2)
    reqs = [cl.add_request([i + 1, 2, 3], 3, arrival_time=100.0)
            for i in range(5)]
    over = [r for r in reqs if r.rejected]
    assert len(over) == 3 and all(
        r.reject_reason == "backlog_full" for r in over)
    assert cl.metrics_summary()["requests_shed"] == 3
    cl._test_clock[0] = 100.0
    _drain(cl, invariants=True)
    assert set(cl.finished) == {r.req_id for r in reqs if not r.rejected}
    cl.close()


# ---------------------------------------------------------------------------
# the seeded chaos fuzz and the smoke gate
# ---------------------------------------------------------------------------


def test_chaos_fuzz_invariants_hold(model_state, shared_fn):
    """A randomized ~300-event FaultPlan over a disaggregated cluster:
    invariants after every step, nothing lost, every output the
    fault-free run's."""
    state, cfg, _ = model_state
    rng = np.random.RandomState(9)
    prompts = _trace(rng, 10)
    NEW = 6
    want = _fault_free(state, cfg, shared_fn, prompts, NEW, "f_fzref",
                       **DISAGG)
    plan = FaultPlan.random(seed=1234, num_replicas=3, steps=60,
                            n_events=300, protect=(0,))
    assert plan.n_events >= 200, plan.describe()
    cl = _disagg(state, cfg, shared_fn, "f_fuzz", plan)
    reqs = [cl.add_request(p, NEW, arrival_time=float(i))
            for i, p in enumerate(prompts)]
    _drain(cl, limit=1500, invariants=True)
    assert set(cl.finished) == {r.req_id for r in reqs}, "request lost"
    for r in reqs:
        assert r.out_tokens == want[r.req_id], (r.req_id, plan.describe())
        assert len(r.out_tokens) == NEW
    assert cl.chaos.injected, "no fault ever fired"
    cl.close()


SMOKE_PLAN = dict(events=[FaultEvent(step=4, kind="crash", target=2)],
                  transport={0: ("drop", 0.0), 1: ("dup", 0.0)})


def test_chaos_smoke_gate(model_state, shared_fn):
    """One crash, one drop and one dup over a small disaggregated trace:
    invariants after every step, nothing lost, outputs exact, and the
    trace carries fault / detect / recover instants."""
    state, cfg, _ = model_state
    rng = np.random.RandomState(12)
    prompts = _trace(rng, 4)
    NEW = 6
    want = _fault_free(state, cfg, shared_fn, prompts, NEW, "f_smref",
                       **DISAGG)
    tracer = SpanTracer()
    cl = _disagg(state, cfg, shared_fn, "f_smoke", FaultPlan(**SMOKE_PLAN),
                 tracer=tracer)
    reqs = [cl.add_request(p, NEW, arrival_time=float(i))
            for i, p in enumerate(prompts)]
    _drain(cl, invariants=True)
    assert set(cl.finished) == {r.req_id for r in reqs}
    for r in reqs:
        assert r.out_tokens == want[r.req_id]
    names = [e.name for e in tracer.events()]
    for n in ("fault", "replica_dead", "handoff_retry",
              "duplicate_dropped"):
        assert n in names, n
    ms = cl.metrics_summary()
    assert ms["replica_deaths"] == 1
    assert ms["handoff_retries"] >= 1
    assert ms["duplicate_deliveries_dropped"] >= 1
    cl.close()


def test_chaos_run_matches_jax(model_state, shared_fn):
    """The smoke gate's plan on a disaggregated trace through the JAX
    cluster and the port's: equal tokens, placements, failure-plane
    counters, injected faults, protocol events and handoff records
    (``predicted_s`` within 1e-12 relative)."""
    from hetu_tpu.fault import FaultEvent as JaxFaultEvent
    from hetu_tpu.serving.decode import build_unified_step_fn as jax_build
    state, cfg, jstate = model_state
    rng = np.random.RandomState(12)
    prompts = _trace(rng, 5)
    jfn = jax_build(JaxGPTConfig(**CFG_KW), SHAPE_KW["max_batch"],
                    SHAPE_KW["chunk_size"], SHAPE_KW["prefill_rows"],
                    -(-SHAPE_KW["max_model_len"] // SHAPE_KW["page_size"]),
                    SHAPE_KW["page_size"], use_kernel=False)
    jplan = JaxFaultPlan(
        events=[JaxFaultEvent(step=4, kind="crash", target=2)],
        transport=dict(SMOKE_PLAN["transport"]))
    runs = {}
    for name, st, c, cls, fn, chaos, transport in (
            ("jax", jstate, JaxGPTConfig(**CFG_KW), JaxEngineCluster, jfn,
             JaxChaos(jplan),
             JaxTransport(JaxClusterSpec(chip=JaxChipSpec(**SPEC_NUMBERS)))),
            ("port", state, cfg, EngineCluster, shared_fn,
             ChaosController(FaultPlan(**SMOKE_PLAN)),
             LocalPageTransport(ClusterSpec(chip=ChipSpec(**SPEC_NUMBERS))))):
        cl = _make_cluster(st, c, fn, cls=cls, name=f"f_par_{name}",
                           chaos=chaos, transport=transport, **DISAGG)
        reqs = [cl.add_request(p, 6, arrival_time=float(i))
                for i, p in enumerate(prompts)]
        _drain(cl)
        ms = cl.metrics_summary()
        runs[name] = {
            "tokens": [r.out_tokens for r in reqs],
            "placement": [(r.replica, r.prefill_replica, r.n_reroutes)
                          for r in reqs],
            "counters": {k: ms[k] for k in (
                "replica_deaths", "handoff_retries", "handoffs_restaged",
                "duplicate_deliveries_dropped", "stale_completions_dropped",
                "requests_rerouted", "cluster_handoffs", "cluster_routed",
                "tokens_generated", "preemptions")},
            "injected": [(e["step"], e["kind"], e["target"], e["ts"])
                         for e in cl.chaos.injected],
            "protocol": [(e["ev"], e["key"], e.get("epoch"))
                         for e in cl.protocol_log],
            "records": [{k: v for k, v in r.items()
                         if k not in ("wall_s", "seq")}
                        for r in cl.transport.records]}
        cl.close()
    jax, port = runs["jax"], runs["port"]
    assert port["counters"]["replica_deaths"] == 1
    for k in ("tokens", "placement", "counters", "injected", "protocol"):
        assert port[k] == jax[k], k
    assert len(port["records"]) == len(jax["records"]) > 0
    for g, w in zip(port["records"], jax["records"]):
        assert g["predicted_s"] == pytest.approx(w["predicted_s"],
                                                 rel=1e-12)
        assert {k: g[k] for k in g if k != "predicted_s"} == \
            {k: w[k] for k in w if k != "predicted_s"}


def test_training_plane_faults_are_refused(model_state, shared_fn):
    """A serving controller ignores the kinds only a trainer consumes (the
    fault-tolerant trainer, tests/test_torch_ft.py), as the JAX
    package's does: recorded in its audit log, no replica touched, the
    request served."""
    state, cfg, _ = model_state
    plan = FaultPlan(events=[FaultEvent(step=0, kind="grad_nan", target=0),
                             FaultEvent(step=0, kind="worker_death",
                                        target=0)])
    chaos = ChaosController(plan)
    cl = _make_cluster(state, cfg, shared_fn, num_replicas=1,
                       name="f_train_kind", chaos=chaos)
    req = cl.add_request([1, 2, 3], 2, arrival_time=0.0)
    cl.step()
    assert [e["kind"] for e in chaos.injected] == ["grad_nan",
                                                   "worker_death"]
    assert all(r.alive for r in cl.replicas)
    cl.run()
    assert len(req.out_tokens) == 2
    cl.close()


# ---------------------------------------------------------------------------
# the coordinator on a real clock
# ---------------------------------------------------------------------------


def test_coordinator_heartbeat_health_on_a_real_clock():
    """A localhost server and two clients: ranks, the KV store, a
    barrier, and heartbeat-driven health under a 1 s TTL; the client
    whose heartbeats stop is reported dead, the other stays alive, and
    a refused window does not kill a heartbeat thread."""
    import threading
    with CoordinatorServer(world_size=2, ttl=1.0) as srv:
        a = CoordinatorClient(srv.address, uid="a", ttl=1.0)
        b = CoordinatorClient(srv.address, uid="b", ttl=1.0)
        try:
            assert (a.connect(), b.connect()) == (0, 1)
            a.put("k", {"v": [1, 2]})
            assert b.get("k") == {"v": [1, 2]}
            t = threading.Thread(target=b.barrier, args=("x",),
                                 kwargs={"timeout": 5.0})
            t.start()
            a.barrier("x", timeout=5.0)
            t.join(5.0)
            assert not t.is_alive()
            stop_a = a.start_heartbeat_thread(interval=0.05)
            stop_b = b.start_heartbeat_thread(interval=0.05)
            srv.refuse_for(0.15)        # both threads back off, survive
            time.sleep(0.3)
            stop_b.set()                # b's process "dies"
            deadline = time.time() + 4.0
            while srv.dead_ranks() != [1] and time.time() < deadline:
                time.sleep(0.05)
            assert srv.dead_ranks() == [1]
            assert a.alive() == ([0], [1])
            stop_a.set()
            b.exit()
            assert srv.dead_ranks(ttl=0.0) == [0]
        finally:
            for c in (a, b):
                c.close()
