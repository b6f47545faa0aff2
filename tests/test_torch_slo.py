"""The port's SLO traffic plane on the CPU: the JAX package's
``tests/test_slo.py`` one for one, and the port against the JAX package
on the same weights and traces.

The weights are built by the JAX model (seed 3; the rotary MLA base from
seed 7, converted by the JAX ``mla_state_from``) and carried across with
``state_from_numpy``; vocab 97, hidden 32, 2 layers, fp32, the JAX
suite's ``SHAPE_KW``, a synthetic clock and ``coordinator=False``.

- One for one: class ranks and validation, the class-ranked queue, the
  class backlog's shed candidate and expired head, preemption victims
  lowest class first (equal to ``generate``), shed order at the front
  door, the autoscaler against a static fleet, a chaos crash during a
  drain, a drain deferred under an in-flight handoff, the host tier's
  evict -> refetch round trip in the latent, rotary-latent and int8
  layouts, its metrics across ``reset_metrics``, and a lying reclaim
  hook falling through to preemption.
- Against JAX: the host tier's records (``dir``, pages, bytes, chain
  hash, edge equal; ``predicted_s`` within 1e-12 relative, both
  packages' ``ClusterSpec`` built from the same numbers) and tokens in
  the three layouts; the autoscaler's actions (every replica's alive /
  serving / draining state after every step), tokens and counters under
  one clock trace.
"""
import numpy as np
import pytest

import hetu_tpu as jht
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPTLMHeadModel
from hetu_tpu.models.gpt import mla_state_from as jax_mla_state_from
from hetu_tpu.planner.cost_model import ChipSpec as JaxChipSpec
from hetu_tpu.planner.cost_model import ClusterSpec as JaxClusterSpec
from hetu_tpu.serving import Engine as JaxEngine
from hetu_tpu.serving import EngineCluster as JaxEngineCluster
from hetu_tpu.serving.slo import Autoscaler as JaxAutoscaler
from hetu_tpu.serving.slo import HostTier as JaxHostTier
from hetu_tpu_torch.fault import (ChaosController, FaultEvent, FaultPlan,
                                  check_cluster_invariants)
from hetu_tpu_torch.models import GPTConfig
from hetu_tpu_torch.models.convert import state_from_numpy
from hetu_tpu_torch.models.generate import generate
from hetu_tpu_torch.planner.cost_model import ChipSpec, ClusterSpec
from hetu_tpu_torch.serving import Engine, EngineCluster
from hetu_tpu_torch.serving.kv_pool import PagedKVPool
from hetu_tpu_torch.serving.request import Request, RequestQueue
from hetu_tpu_torch.serving.decode import build_unified_step_fn
from hetu_tpu_torch.serving.slo import (Autoscaler, ClassBacklog, HostTier,
                                        SLO_CLASSES, class_rank)

CFG_KW = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=64, sp=False, dropout=0.0)
SHAPE_KW = dict(page_size=8, max_batch=4, chunk_size=8, prefill_rows=1,
                max_model_len=56)
SPEC_NUMBERS = dict(name="parity", peak_flops=1e15, hbm_bytes=8e10,
                    hbm_bw=3e12, ici_bw=2e11, ici_links=4,
                    ici_latency=2e-6, dcn_bw=2.5e10, dcn_latency=1e-5)


def _jax_state(cfg_kw, seed):
    jht.set_seed(seed)
    with jht.graph("eager", create_new=True):
        model = JaxGPTLMHeadModel(JaxGPTConfig(**cfg_kw))
        model.logits(np.zeros((1, 4), np.int32))
        return {k: np.asarray(v) for k, v in model.state_dict().items()}


def _port_cfg(jcfg):
    import dataclasses
    return GPTConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def model_state():
    cfg = GPTConfig(**CFG_KW)
    jstate = _jax_state(CFG_KW, 3)
    return state_from_numpy(jstate, cfg, device="cpu"), cfg, jstate


@pytest.fixture(scope="module")
def shared_fn():
    return build_unified_step_fn(
        GPTConfig(**CFG_KW), SHAPE_KW["max_batch"], SHAPE_KW["chunk_size"],
        SHAPE_KW["prefill_rows"],
        -(-SHAPE_KW["max_model_len"] // SHAPE_KW["page_size"]),
        SHAPE_KW["page_size"], device="cpu")


@pytest.fixture(scope="module")
def jax_fn():
    from hetu_tpu.serving.decode import build_unified_step_fn as jax_build
    return jax_build(
        JaxGPTConfig(**CFG_KW), SHAPE_KW["max_batch"],
        SHAPE_KW["chunk_size"], SHAPE_KW["prefill_rows"],
        -(-SHAPE_KW["max_model_len"] // SHAPE_KW["page_size"]),
        SHAPE_KW["page_size"], use_kernel=False)


def _solo(state, cfg, prompt, n_new):
    return generate(state, cfg, [prompt], n_new,
                    device="cpu")[0, len(prompt):].tolist()


def _make_engine(state, cfg, cls=Engine, **kw):
    clock = [0.0]
    kw.setdefault("time_fn", lambda: clock[0])
    kw.setdefault("debug", True)
    for k, v in SHAPE_KW.items():
        kw.setdefault(k, v)
    if cls is Engine:
        kw.setdefault("device", "cpu")
    else:
        kw.setdefault("use_kernel", False)
    eng = cls(state, cfg, **kw)
    eng._test_clock = clock
    return eng


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


def _drain(obj, limit=500, invariants=False, each=None):
    n = 0
    while obj.has_work:
        obj.step()
        obj._test_clock[0] += 1.0
        if invariants:
            check_cluster_invariants(obj)
        if each is not None:
            each(obj)
        n += 1
        assert n < limit, "did not drain"
    return n


# ---------------------------------------------------------------------------
# units: classes, queue, backlog
# ---------------------------------------------------------------------------


def test_class_rank_and_validation():
    assert [class_rank(c) for c in SLO_CLASSES] == [0, 1, 2]
    with pytest.raises(ValueError):
        class_rank("platinum")
    with pytest.raises(ValueError):
        Request(req_id=0, prompt=[1], max_new_tokens=1,
                slo_class="platinum")


def test_request_queue_rank_major_with_per_class_arrival_gate():
    q = RequestQueue()
    mk = (lambda rid, c, t: Request(req_id=rid, prompt=[1],
                                    max_new_tokens=1, slo_class=c,
                                    arrival_time=t))
    q.push(mk(0, "batch", 0.0))
    q.push(mk(1, "interactive", 5.0))       # future
    q.push(mk(2, "standard", 0.0))
    assert q.next_arrival() == 0.0
    # a FUTURE interactive must not gate an arrived lower class
    assert q.pop_ready(1.0).req_id == 2
    assert q.pop_ready(1.0).req_id == 0
    assert q.pop_ready(1.0) is None
    assert q.next_arrival() == 5.0
    q.push(mk(3, "batch", 0.0))
    assert q.pop_ready(6.0).req_id == 1
    assert q.depth_by_class() == {"interactive": 0, "standard": 0,
                                  "batch": 1}


def test_class_backlog_shed_candidate_and_expired_head():
    class _C:
        def __init__(self, rid, c, arr):
            self.req_id, self.slo_class = rid, c
            self.arrival_time = self.submit_time = arr
    b = ClassBacklog()
    for rid, c, arr in ((0, "interactive", 0.0), (1, "batch", 0.0),
                        (2, "batch", 2.0), (3, "standard", 1.0)):
        b.push(_C(rid, c, arr))
    assert len(b) == 4 and bool(b)
    assert [rid for _a, rid, _c in b] == [0, 3, 1, 2]
    assert b.shed_candidate().req_id == 2
    assert b.expired_head(10.0, None) is None
    assert b.expired_head(10.0, 5.0).req_id == 1      # batch before std
    b.remove(b.shed_candidate())
    b.remove(b.expired_head(10.0, 5.0))
    assert b.expired_head(10.0, 5.0).req_id == 3      # std before inter
    assert b.depth_by_class() == {"interactive": 1, "standard": 1,
                                  "batch": 0}
    assert b.peek_ready(0.5).req_id == 0


# ---------------------------------------------------------------------------
# class-aware packing + preemption order
# ---------------------------------------------------------------------------


def test_preemption_victims_lowest_class_first_bitwise(model_state,
                                                       shared_fn):
    """Page pressure on a mixed-class batch: ONLY batch requests are
    preempted (asserted non-vacuous), and every output still equals
    ``generate``."""
    state, cfg, _ = model_state
    eng = _make_engine(state, cfg, num_pages=9, name="slo_preempt",
                       step_fn=shared_fn)
    classes = ["interactive", "batch", "interactive", "batch"]
    prompts, reqs = {}, []
    for i, c in enumerate(classes):
        p = [int(t) for t in range(2 + i, 14 + i)]    # 12 tokens: 2 pages
        r = eng.add_request(p, max_new_tokens=8, slo_class=c)
        prompts[r.req_id] = p
        reqs.append(r)
    _drain(eng)
    assert eng.counters["preempted_batch"].value >= 1, \
        "no batch preemption: the class-order claim is vacuous"
    assert eng.counters["preempted_interactive"].value == 0
    assert eng.counters["admitted_interactive"].value >= 2
    for r in reqs:
        assert eng.finished[r.req_id].out_tokens == \
            _solo(state, cfg, prompts[r.req_id], 8), r.req_id
    eng.pool.check_invariants(force=True)


# ---------------------------------------------------------------------------
# shed order at the cluster front door
# ---------------------------------------------------------------------------


def test_shed_order_displacement_and_deadline(model_state, shared_fn):
    state, cfg, _ = model_state
    cl = _make_cluster(state, cfg, shared_fn, num_replicas=1,
                       name="slo_shed", max_backlog=2,
                       max_queue_depth=1, request_deadline=5.0)
    for _ in range(3):
        cl.add_request([5, 6, 7], 3, arrival_time=100.0,
                       slo_class="batch")
    assert cl.counters["shed_batch"].value == 1        # backlog_full
    r = cl.add_request([8, 9, 10], 3, arrival_time=100.0,
                       slo_class="interactive")
    assert not r.rejected
    assert cl.counters["shed_batch"].value == 2
    assert cl.shed and all(c.slo_class == "batch"
                           for c in cl.shed.values())
    assert cl._backlog.depth_by_class() == \
        {"interactive": 1, "standard": 0, "batch": 1}
    r2 = cl.add_request([11, 12], 3, arrival_time=100.0,
                        slo_class="batch")
    assert r2.rejected and r2.reject_reason == "backlog_full"
    cl._test_clock[0] = 100.0
    _drain(cl)
    assert cl.counters["class_inversions"].value == 0
    assert cl.counters["shed_interactive"].value == 0
    ms = cl.metrics_summary()
    assert ms["shed_batch"] == ms["cluster_shed_batch"] == 3.0
    cl.close()


# ---------------------------------------------------------------------------
# autoscaler: equal to a static fleet, drain lifecycle, chaos overlay
# ---------------------------------------------------------------------------


def _mixed_trace(rng, n):
    out = []
    for i in range(n):
        size = int(rng.randint(4, 12))
        cls = SLO_CLASSES[int(rng.randint(3))]
        out.append(([int(t) for t in rng.randint(1, 90, size=size)],
                    cls, float(i)))
    return out


def _autoscale_run(state, cfg, fn, autoscaler, cls=EngineCluster,
                   idle_steps=10, name="slo_auto"):
    """The JAX suite's autoscale trace: an idle window (scale-down bait),
    then 8 mixed-class requests of 6 new tokens on 2 replicas; returns
    the tokens, the summary and each step's (alive, serving, draining)
    of every replica."""
    rng = np.random.RandomState(11)
    trace = _mixed_trace(rng, 8)
    cl = _make_cluster(state, cfg, fn, cls=cls, num_replicas=2, name=name,
                       policy="load", max_queue_depth=2,
                       autoscaler=autoscaler)
    states = []

    def record(c):
        states.append(tuple((r.alive, r.serving, r.draining)
                            for r in c.replicas))

    for _ in range(idle_steps):
        cl.step()
        cl._test_clock[0] += 1.0
        record(cl)
    t0 = cl._test_clock[0]
    reqs = [cl.add_request(p, 6, arrival_time=t0 + arr, slo_class=c)
            for p, c, arr in trace]
    _drain(cl, invariants=cls is EngineCluster, each=record)
    out = {r.req_id - reqs[0].req_id: list(r.out_tokens) for r in reqs}
    ms = cl.metrics_summary()
    cl.close()
    return out, ms, states


def _auto():
    return dict(min_replicas=1, backlog_high=4, backlog_low=0,
                hysteresis_steps=2, cooldown_steps=3, ttft_target=None)


def test_autoscale_up_down_bitwise_vs_static_fleet(model_state,
                                                   shared_fn):
    """The autoscaler drains a replica on an idle fleet and readmits it
    under backlog pressure (both asserted), and the requests' tokens
    equal the same trace's on a static 2-replica fleet."""
    state, cfg, _ = model_state
    auto = Autoscaler(**_auto())
    managed, ms, _ = _autoscale_run(state, cfg, shared_fn, auto)
    static, ms_static, _ = _autoscale_run(state, cfg, shared_fn, None)
    assert managed == static, "autoscaling changed a request's tokens"
    assert ms["scale_downs"] >= 1, "no scale-down: test is vacuous"
    assert ms["scale_ups"] >= 1, "no scale-up: test is vacuous"
    assert ms["class_inversions"] == 0
    assert ms_static["scale_ups"] == ms_static["scale_downs"] == 0
    assert auto.scale_up_events == ms["scale_ups"]


def test_autoscaler_actions_match_jax(model_state, shared_fn, jax_fn):
    """The same clock trace through the JAX cluster's autoscaler and the
    port's: every replica's (alive, serving, draining) after every step,
    the tokens and the cluster counters are equal."""
    state, cfg, jstate = model_state
    got = _autoscale_run(state, cfg, shared_fn, Autoscaler(**_auto()),
                         name="auto_port")
    want = _autoscale_run(jstate, JaxGPTConfig(**CFG_KW), jax_fn,
                          JaxAutoscaler(**_auto()), cls=JaxEngineCluster,
                          name="auto_jax")
    assert got[2] == want[2]
    assert got[0] == want[0]
    for k in ("scale_ups", "scale_downs", "readmits", "replica_deaths",
              "class_inversions", "requests_shed", "cluster_routed",
              "tokens_generated", "preemptions"):
        assert got[1][k] == want[1][k], k


def test_chaos_death_during_scale_down_no_double_drain(model_state,
                                                       shared_fn):
    """The chaos plan crashes the replica the autoscaler is draining,
    mid-drain: the death sweep re-routes its work (outputs fault-free),
    the controller clears its drain intent without a second kill, and
    the scale-down counts once."""
    state, cfg, _ = model_state
    prompts = [[int(t) for t in range(3 + i, 13 + i)] for i in range(3)]
    NEW = 8
    want = {i: _solo(state, cfg, p, NEW) for i, p in enumerate(prompts)}
    plan = FaultPlan(events=[FaultEvent(step=4, kind="crash", target=1)])
    auto = Autoscaler(min_replicas=1, backlog_high=99, backlog_low=99,
                      hysteresis_steps=2, cooldown_steps=50,
                      ttft_target=None)
    cl = _make_cluster(state, cfg, shared_fn, num_replicas=2,
                       name="slo_chaos", policy="load",
                       chaos=ChaosController(plan), autoscaler=auto)
    reqs = [cl.add_request(p, NEW, arrival_time=0.0) for p in prompts]
    for _ in range(3):
        cl.step()
        cl._test_clock[0] += 1.0
    assert cl.replicas[1].draining, "drain intent never landed"
    assert cl.replicas[1].engine.has_work, \
        "victim idle: the crash would not land mid-drain"
    _drain(cl, invariants=True)
    assert set(cl.finished) == {r.req_id for r in reqs}
    for i, r in enumerate(reqs):
        assert r.out_tokens == want[i], i
    ms = cl.metrics_summary()
    assert ms["replica_deaths"] == 1
    assert ms["scale_downs"] == 1, "double-drain (or lost drain)"
    assert ms["readmits"] == 0
    assert not cl.replicas[1].draining
    assert not cl.replicas[1].alive
    cl.close()


def test_drain_deferred_while_handoff_inflight(model_state, shared_fn):
    """A chaos-delayed handoff in flight to a draining replica whose
    engine looks idle: the autoscaler defers the kill until the handoff
    lands or re-routes, and counts the deferral."""
    state, cfg, _ = model_state
    auto = Autoscaler(min_replicas=1, backlog_high=99, backlog_low=99,
                      hysteresis_steps=2, cooldown_steps=50,
                      ttft_target=None)
    cl = _make_cluster(state, cfg, shared_fn, num_replicas=2,
                       name="slo_drain_inflight", policy="load",
                       autoscaler=auto)
    try:
        auto._draining.add(1)
        cl.replicas[1].draining = True
        assert not cl.replicas[1].engine.has_work
        assert not any(k[0] == 1 for k in cl._placed)
        cl._pending_handoffs.append(
            {"creq": None, "staged": None, "src": 0, "dst": 1,
             "dst_pages": (), "lands_at": 999.0, "attempt": 0,
             "not_before": float("-inf"), "epoch": 7})
        auto._finish_drains(cl, now=0.0)
        assert cl.replicas[1].alive and cl.replicas[1].serving, \
            "drain killed the replica under an in-flight handoff"
        assert cl.replicas[1].draining and 1 in auto._draining
        assert cl.counters["drains_deferred_inflight"].value == 1
        assert cl.counters["scale_downs"].value == 0
        cl._pending_handoffs.clear()
        auto._finish_drains(cl, now=1.0)
        assert not cl.replicas[1].serving
        assert not cl.replicas[1].draining and 1 not in auto._draining
        assert cl.counters["scale_downs"].value == 1
        assert cl.metrics_summary()["cluster_drains_deferred_inflight"] \
            == 1
    finally:
        cl.close()


# ---------------------------------------------------------------------------
# host tier: evict -> refetch across layouts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mla_states(model_state):
    _, _, jstate = model_state
    lstate, lcfg = jax_mla_state_from(jstate, JaxGPTConfig(**CFG_KW),
                                      kv_latent_dim=16)
    rkw = dict(position="rotary", norm="rmsnorm", activation="swiglu",
               **CFG_KW)
    rstate, rcfg = jax_mla_state_from(_jax_state(rkw, 7),
                                      JaxGPTConfig(**rkw),
                                      kv_latent_dim=16, kv_rope_dim=4)
    out = {}
    for name, (js, jc, quant) in {"mla": (lstate, lcfg, None),
                                  "mla_rot": (rstate, rcfg, None),
                                  "int8": (lstate, lcfg, "int8")}.items():
        pc = _port_cfg(jc)
        out[name] = (state_from_numpy(js, pc, device="cpu"), pc, quant,
                     js, jc)
    return out


HEADER = list(range(1, 18))            # two full pages at ps=8
TAILS = ([21, 22], [31, 32])


def _host_run(make, evict):
    """The JAX suite's host-tier trace: two same-header requests, with
    a cold sweep of every cached page after each under ``evict``."""
    eng = make()
    outs = []
    for tail in TAILS:
        r = eng.add_request(HEADER + tail, max_new_tokens=5)
        _drain(eng)
        outs.append(list(eng.finished[r.req_id].out_tokens))
        if evict:
            eng.prefix_cache.evict(16)
            assert eng.pool.cached_pages == 0
    eng.pool.check_invariants(force=True)
    eng.prefix_cache.check_invariants()
    return eng, outs


@pytest.mark.parametrize("layout", ["mla", "mla_rot", "int8"])
def test_host_tier_evict_refetch_bitwise(mla_states, layout):
    """A cold sweep pushes cached pages to host staging, a same-header
    request pulls them back through the priced transport, and the
    output equals a never-evicted run's, in the latent, rotary-latent
    and int8 page layouts (each priced at its own page_bytes)."""
    state, cfg, quant = mla_states[layout][:3]

    def make(evict):
        return lambda: _make_engine(
            state, cfg, num_pages=16, host_tier=True, page_quant=quant,
            name=f"slo_host_{layout}_{int(evict)}")

    eng, evicted_outs = _host_run(make(True), True)
    _, warm_outs = _host_run(make(False), False)
    assert evicted_outs == warm_outs, "host-tier round trip changed tokens"
    assert eng.host_tier.evictions >= 2, "sweep staged nothing"
    assert eng.host_tier.hits >= 2, "second request never refetched"
    assert eng.counters["host_hits"].value == eng.host_tier.hits
    assert eng.counters["prefix_cache_hits"].value >= 1, \
        "refetch did not re-enter the cache index"
    recs = eng.host_tier.records
    assert {r["dir"] for r in recs} == {"evict", "refetch"}
    for r in recs:
        assert r["payload_bytes"] == r["pages"] * eng.pool.page_bytes
        assert r["edge"]["tag"] == "host_offload"
        assert r["predicted_s"] > 0
        assert r["wall_s"] > 0
    assert eng.gauges["host_pages"].value == eng.host_tier.host_pages


@pytest.mark.parametrize("layout", ["mla", "mla_rot", "int8"])
def test_host_tier_matches_jax(mla_states, layout):
    """The same evict -> refetch trace on the JAX engine and the port's:
    equal tokens and equal host-tier records, field for field."""
    state, cfg, quant, jstate, jcfg = mla_states[layout]
    pspec = ClusterSpec(chip=ChipSpec(**SPEC_NUMBERS))
    jspec = JaxClusterSpec(chip=JaxChipSpec(**SPEC_NUMBERS))
    peng, pouts = _host_run(lambda: _make_engine(
        state, cfg, num_pages=16, page_quant=quant,
        host_tier=HostTier(cluster_spec=pspec)), True)
    jeng, jouts = _host_run(lambda: _make_engine(
        jstate, jcfg, cls=JaxEngine, num_pages=16, page_quant=quant,
        host_tier=JaxHostTier(cluster_spec=jspec),
        name=f"slo_host_jax_{layout}"), True)
    assert pouts == jouts
    got, want = peng.host_tier.records, jeng.host_tier.records
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert {k: g[k] for k in g if k not in ("wall_s", "seq",
                                                "predicted_s")} == \
            {k: w[k] for k in w if k not in ("wall_s", "seq",
                                             "predicted_s")}
        assert g["predicted_s"] == pytest.approx(w["predicted_s"],
                                                 rel=1e-12)
    for k in ("host_evictions", "host_hits", "host_refetch_bytes",
              "prefix_cache_hits", "prefix_cache_evictions"):
        assert peng.counters[k].value == jeng.counters[k].value, k


def test_host_tier_metrics_and_reset_robustness(model_state, shared_fn):
    """Host counters are always present (uniform cluster merge) and the
    tier survives ``reset_metrics``: instruments are looked up by key
    at use time, so post-reset evictions still count."""
    state, cfg, _ = model_state
    eng = _make_engine(state, cfg, num_pages=16, name="slo_host_reset",
                       step_fn=shared_fn, host_tier=True)
    txt = eng.metrics_text()
    for key in ("host_evictions", "host_hits", "host_refetch_bytes",
                "host_pages"):
        assert key in txt, key
    eng.add_request(HEADER + [21, 22], max_new_tokens=4)
    _drain(eng)
    eng.reset_metrics()
    eng.prefix_cache.evict(16)
    assert eng.counters["host_evictions"].value >= 2, \
        "post-reset instruments lost the host tier"
    eng.add_request(HEADER + [31, 32], max_new_tokens=4)
    _drain(eng)
    assert eng.counters["host_hits"].value >= 2
    # without a prefix cache there is nothing to tier
    with pytest.raises(ValueError, match="prefix_cache"):
        _make_engine(state, cfg, num_pages=16, host_tier=True,
                     prefix_cache=False)


# ---------------------------------------------------------------------------
# partial reclaim degrades cleanly
# ---------------------------------------------------------------------------


def test_alloc_partial_reclaim_falls_through_to_none():
    """A reclaim hook that claims more than it delivers: ``alloc``
    trusts only the free list (a clean ``None``, no short grant) and
    counts the shortfall."""
    pool = PagedKVPool(num_layers=1, num_pages=4, page_size=8,
                       kv_heads=1, head_dim=4, device="cpu")
    got = pool.alloc(3)
    assert got is not None and len(got) == 3
    lies = []

    def lying_sweep(n):
        lies.append(n)
        return n                            # claims n, delivers 0

    pool.set_reclaim(lying_sweep)
    assert pool.alloc(2) is None
    assert lies == [2]
    assert pool.reclaim_shortfalls == 1
    pool.check_invariants()
    pool.free(got[:1])
    pool.set_reclaim(lambda n: 0)           # delivers nothing, says so
    assert pool.alloc(3) is None
    assert pool.reclaim_shortfalls == 1     # honesty is not a shortfall
    assert pool.alloc(1) is not None
    pool.check_invariants()


def test_engine_survives_lying_reclaim_via_preemption(model_state,
                                                      shared_fn):
    """With the cache's sweep replaced by a liar, page pressure falls
    through to recompute preemption and the outputs stay equal to
    ``generate``."""
    state, cfg, _ = model_state
    eng = _make_engine(state, cfg, num_pages=9, name="slo_lying",
                       step_fn=shared_fn, prefix_cache=False)
    eng.pool.set_reclaim(lambda n: n)       # claims n, delivers 0
    prompts = {}
    for i in range(4):
        p = [int(t) for t in range(2 + i, 14 + i)]
        r = eng.add_request(p, max_new_tokens=8)
        prompts[r.req_id] = p
    _drain(eng)
    assert eng.pool.reclaim_shortfalls >= 1, "liar never consulted"
    assert eng.counters["preemptions"].value >= 1, \
        "no preemption: the fall-through claim is vacuous"
    for rid, p in prompts.items():
        assert eng.finished[rid].out_tokens == _solo(state, cfg, p, 8)
    eng.pool.check_invariants(force=True)
