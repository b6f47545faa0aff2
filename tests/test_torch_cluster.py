"""The port's serving cluster plane on the CPU: the JAX package's
``tests/test_cluster.py`` one for one, and the port against the JAX
cluster on the same weights and traces.

The weights are built by the JAX model from seed 3 and carried across
with ``state_from_numpy`` (vocab 97, hidden 32, 2 layers, fp32); the
shapes are the JAX suite's ``SHAPE_KW``.  Every cluster runs on a
synthetic clock with ``coordinator=False``, except the death test,
which ages its dead replica's heartbeat past the TTL instead of waiting
for it (tests/test_torch_fault.py holds the coordinator on a real
clock).

- One for one: the digest against the chain hashes, router
  backpressure, the admission roll-back of deferred pins, impossible
  adoptions refused, prefix-aware placement beating random, the
  disaggregated cluster equal to a monolithic engine under preemption,
  EOS on the first token, re-route on death, the merged Prometheus
  exposition, reset-robust sums, one step for the fleet.  The handoff
  pricing rule test waits for the analysis plane (ROADMAP queue 1
  item 18).
- Against JAX (tolerances: tokens, placements, counters and protocol
  events equal; transport records equal field for field, ``predicted_s``
  within 1e-12 relative, both packages' ``ClusterSpec`` built from the
  same explicit numbers): a replicated and a disaggregated trace, and
  the engine's tracer events (names, tracks, timestamps).
- The port alone: a sampled request gives the same tokens whatever its
  placement; the default transport prices on the H100 SXM; a shared
  step refuses an engine of another layout.
"""
import dataclasses

import numpy as np
import pytest

import hetu_tpu as jht
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPTLMHeadModel
from hetu_tpu.obs.tracer import SpanTracer as JaxSpanTracer
from hetu_tpu.planner.cost_model import ChipSpec as JaxChipSpec
from hetu_tpu.planner.cost_model import ClusterSpec as JaxClusterSpec
from hetu_tpu.serving import Engine as JaxEngine
from hetu_tpu.serving import EngineCluster as JaxEngineCluster
from hetu_tpu.serving.cluster import LocalPageTransport as JaxTransport
from hetu_tpu_torch.models import GPTConfig
from hetu_tpu_torch.models.convert import state_from_numpy
from hetu_tpu_torch.models.generate import generate
from hetu_tpu_torch.obs import SpanTracer
from hetu_tpu_torch.planner.cost_model import ChipSpec, ClusterSpec
from hetu_tpu_torch.serving import (Engine, EngineCluster, PagedKVPool,
                                    PrefixCache, Request, RequestQueue,
                                    Scheduler)
from hetu_tpu_torch.serving.cluster import (LocalPageTransport,
                                            digest_match_pages)
from hetu_tpu_torch.serving.decode import build_unified_step_fn
from hetu_tpu_torch.serving.prefix_cache import token_chain_hashes

CFG_KW = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=64, sp=False, dropout=0.0)
SHAPE_KW = dict(page_size=8, max_batch=4, chunk_size=8, prefill_rows=1,
                max_model_len=56)
# one interconnect for both packages' pricing (the port's default is the
# H100 SXM, the JAX package's a TPU v5p)
SPEC_NUMBERS = dict(name="parity", peak_flops=1e15, hbm_bytes=8e10,
                    hbm_bw=3e12, ici_bw=2e11, ici_links=4,
                    ici_latency=2e-6, dcn_bw=2.5e10, dcn_latency=1e-5)


def _jax_state(seed=3):
    jht.set_seed(seed)
    with jht.graph("eager", create_new=True):
        model = JaxGPTLMHeadModel(JaxGPTConfig(**CFG_KW))
        model.logits(np.zeros((1, 4), np.int32))
        return {k: np.asarray(v) for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def model_state():
    cfg = GPTConfig(**CFG_KW)
    jstate = _jax_state()
    return state_from_numpy(jstate, cfg, device="cpu"), cfg, jstate


@pytest.fixture(scope="module")
def jax_fn():
    from hetu_tpu.serving.decode import build_unified_step_fn as jax_build
    return jax_build(
        JaxGPTConfig(**CFG_KW), SHAPE_KW["max_batch"],
        SHAPE_KW["chunk_size"], SHAPE_KW["prefill_rows"],
        -(-SHAPE_KW["max_model_len"] // SHAPE_KW["page_size"]),
        SHAPE_KW["page_size"], use_kernel=False)


@pytest.fixture(scope="module")
def shared_fn():
    return build_unified_step_fn(
        GPTConfig(**CFG_KW), SHAPE_KW["max_batch"], SHAPE_KW["chunk_size"],
        SHAPE_KW["prefill_rows"],
        -(-SHAPE_KW["max_model_len"] // SHAPE_KW["page_size"]),
        SHAPE_KW["page_size"], device="cpu")


def _solo(state, cfg, prompt, n_new):
    return generate(state, cfg, [prompt], n_new,
                    device="cpu")[0, len(prompt):].tolist()


def _make_cluster(state, cfg, fn=None, cls=EngineCluster, **kw):
    clock = [0.0]
    kw.setdefault("time_fn", lambda: clock[0])
    kw.setdefault("num_pages", 12)
    for k, v in SHAPE_KW.items():
        kw.setdefault(k, v)
    kw.setdefault("debug", True)
    kw.setdefault("ttl", 3600.0)        # the death test ages its replica
    if cls is EngineCluster:
        kw.setdefault("device", "cpu")
    cl = cls(state, cfg, step_fn=fn, **kw)
    cl._test_clock = clock
    return cl


def _drain(cl, limit=500):
    n = 0
    while cl.has_work:
        cl.step()
        cl._test_clock[0] += 1.0
        n += 1
        assert n < limit, "cluster did not drain"
    return n


# ---------------------------------------------------------------------------
# digest / router units
# ---------------------------------------------------------------------------


def test_digest_matches_chain_hashes(model_state, shared_fn):
    """A replica's exported digest is exactly the content-chained view
    of its cache: a request sharing k full pages matches k, a divergent
    request matches 0."""
    state, cfg, _ = model_state
    cl = _make_cluster(state, cfg, shared_fn, num_replicas=1,
                       name="cl_digest", coordinator=False)
    header = list(range(1, 25))          # 3 full pages at page_size 8
    cl.add_request(header + [30, 31], 4, arrival_time=0.0)
    _drain(cl)
    digest = cl.replicas[0].digest()
    assert digest, "finished request populated no cache"
    pool = cl.replicas[0].engine.pool
    ps, tag = pool.page_size, pool.layout_tag
    assert digest_match_pages(header + [77, 78, 79], ps, digest,
                              layout=tag) == 3
    # the chain property: a diverged FIRST page kills every deeper match
    diverged = [50] + header[1:] + [77]
    assert digest_match_pages(diverged, ps, digest, layout=tag) == 0
    hs = token_chain_hashes(header + [77], ps, layout=tag)
    assert [digest.get(h) for h in hs] == [1, 2, 3]
    # layout-salted root: unsalted hashes share no keys with the digest
    assert digest_match_pages(header + [77], ps, digest) == 0
    cl.close()


def test_router_backpressure(model_state, shared_fn):
    """Replicas at max_queue_depth are not placement candidates; when
    every replica is saturated the backlog holds and drains as capacity
    frees."""
    state, cfg, _ = model_state
    cl = _make_cluster(state, cfg, shared_fn, num_replicas=2, name="cl_bp",
                       coordinator=False, max_queue_depth=1)
    prompts = [[i + 1, i + 2, i + 3] for i in range(6)]
    reqs = [cl.add_request(p, 3, arrival_time=0.0) for p in prompts]
    cl.step()                            # routes at most 2 (one each)
    assert sum(1 for r in reqs if r.replica is not None) == 2
    assert len(cl._backlog) == 4
    _drain(cl)
    assert set(cl.finished) == {r.req_id for r in reqs}
    cl.close()


def test_admit_rolls_back_deferred_pins():
    """A deferred (blocked) head must not keep cached-page pins charged
    against the budget: with nothing running, that would re-create the
    deadlock the page-holder overtake exists to break."""
    pool = PagedKVPool(num_layers=1, num_pages=8, page_size=4,
                       kv_heads=1, head_dim=4, debug=True, device="cpu")
    cache = PrefixCache(pool)
    sched = Scheduler(pool, max_batch=4, chunk=4, prefix_cache=cache)
    donor = Request(req_id=0, prompt=list(range(8)), max_new_tokens=1)
    donor.pages = pool.alloc(2)
    donor.pos = 8
    cache.on_finish(donor)
    assert cache.evictable_pages == 2
    # an adopted page-holder: 2 pages attached, 23 accumulated tokens ->
    # needs 4 more; true budget = 3 free + 2 evictable = 5
    holder = Request(req_id=1, prompt=list(range(23)), max_new_tokens=4)
    holder.pages = pool.alloc(2)
    holder.pos = 8
    holder.arrival_time = 1.0
    # a head that MATCHES the cached pages but can never fit right now
    head = Request(req_id=2, prompt=list(range(8)) + list(range(100, 120)),
                   max_new_tokens=1)
    q = RequestQueue()
    q.push(head)
    q.push(holder)
    assert sched.admit(q, [], now=2.0) == [holder]
    assert len(q) == 1                     # head still queued, FIFO


def test_adopt_request_rejects_impossible_requests(model_state,
                                                   shared_fn):
    """adopt_request (and the cluster front door) apply add_request's
    could-never-run pool check."""
    state, cfg, _ = model_state
    cl = _make_cluster(state, cfg, shared_fn, num_replicas=1,
                       name="cl_never", coordinator=False, num_pages=4)
    eng = cl.replicas[0].engine
    with pytest.raises(ValueError, match="could never run"):
        eng.adopt_request(list(range(1, 31)), [7], max_new_tokens=10)
    with pytest.raises(ValueError, match="could never run"):
        cl.add_request(list(range(1, 31)), max_new_tokens=10)
    cl.close()


# ---------------------------------------------------------------------------
# prefix-aware placement
# ---------------------------------------------------------------------------


def _shared_prompt_trace(state, cfg, fn, policy, seed=0):
    """Warm ONE replica with a shared header, then burst same-header
    requests; returns (cluster, holder, burst requests, summary)."""
    cl = _make_cluster(state, cfg, fn, num_replicas=3, policy=policy,
                       name=f"cl_place_{policy}", coordinator=False,
                       seed=seed)
    rng = np.random.RandomState(7)
    header = rng.randint(1, 97, size=24).tolist()   # 3 full pages
    warm = cl.add_request(header + [5, 6], 2, arrival_time=0.0)
    _drain(cl)
    holder = warm.replica
    burst = [cl.add_request(header + [10 + i], 2,
                            arrival_time=cl._test_clock[0])
             for i in range(6)]
    _drain(cl)
    return cl, holder, burst, cl.metrics_summary()


def test_prefix_aware_placement_beats_random(model_state, shared_fn):
    state, cfg, _ = model_state
    cl_p, holder, burst, ms_p = _shared_prompt_trace(state, cfg, shared_fn,
                                                     "prefix")
    assert all(r.replica == holder for r in burst), \
        [(r.req_id, r.replica) for r in burst]
    assert ms_p["prefix_cache_hit_rate"] > 0.8
    assert ms_p["prefix_cache_tokens_saved"] > 0
    cl_p.close()
    cl_r, _, burst_r, ms_r = _shared_prompt_trace(state, cfg, shared_fn,
                                                  "random")
    assert len({r.replica for r in burst_r}) > 1, \
        "random placement degenerated to one replica; weak baseline"
    assert ms_p["prefix_cache_hit_rate"] > ms_r["prefix_cache_hit_rate"]
    assert ms_p["prefix_cache_tokens_saved"] \
        > ms_r["prefix_cache_tokens_saved"]
    cl_r.close()
    for a, b in zip(burst, burst_r):     # placement is invisible at temp 0
        assert a.out_tokens == b.out_tokens


# ---------------------------------------------------------------------------
# disaggregated prefill/decode
# ---------------------------------------------------------------------------


def test_disaggregated_bitforbit_vs_monolithic(model_state, shared_fn):
    """Prefill on a dedicated replica, pages streamed to a decode
    replica: outputs equal the monolithic engine's at temperature 0 on
    a trace with late arrivals, preemption (asserted) and cache
    eviction pressure."""
    state, cfg, _ = model_state
    rng = np.random.RandomState(11)
    lens = [26, 18, 28, 12, 22, 20]
    NEW = 12
    prompts = [rng.randint(1, 97, size=n).tolist() for n in lens]
    mono_clock = [0.0]
    mono = Engine(state, cfg, num_pages=12, name="cl_mono", debug=True,
                  time_fn=lambda: mono_clock[0], step_fn=shared_fn,
                  device="cpu", **{k: SHAPE_KW[k] for k in SHAPE_KW})
    for i, p in enumerate(prompts):
        mono.add_request(p, NEW, arrival_time=float(i))
    while mono.has_work:
        mono.step()
        mono_clock[0] += 1.0
    want = {i: list(mono.finished[i].out_tokens)
            for i in range(len(prompts))}
    assert want[0] == _solo(state, cfg, prompts[0], NEW)

    cl = _make_cluster(state, cfg, shared_fn, num_replicas=2,
                       mode="disaggregated", num_prefill=1,
                       name="cl_disagg", coordinator=False)
    reqs = [cl.add_request(p, NEW, arrival_time=float(i))
            for i, p in enumerate(prompts)]
    _drain(cl)
    ms = cl.metrics_summary()
    assert ms["preemptions"] > 0, "no preemption: trace too easy"
    assert ms["cluster_handoffs"] == len(prompts)
    assert ms["handoff_payload_bytes"] > 0
    assert all(r["predicted_s"] > 0 for r in cl.transport.records)
    for r in reqs:
        assert r.out_tokens == want[r.req_id], \
            (r.req_id, r.out_tokens, want[r.req_id])
    pre = cl.replicas[0].engine.metrics_summary()
    assert pre["requests_completed"] == len(prompts)
    for rep in cl.replicas[1:]:
        assert rep.engine.metrics_summary()["requests_completed"] \
            + pre["requests_completed"] >= len(prompts)
    cl.close()


def test_disaggregated_eos_on_first_token(model_state, shared_fn):
    """A request whose first sampled token is EOS finishes at the
    prefill replica: no handoff, no decode-stage orphan."""
    state, cfg, _ = model_state
    prompt = [9, 8, 7, 6, 5, 4, 3, 2, 1]
    first = _solo(state, cfg, prompt, 1)[0]
    cl = _make_cluster(state, cfg, shared_fn, num_replicas=2,
                       mode="disaggregated", num_prefill=1,
                       name="cl_eos", coordinator=False)
    r = cl.add_request(prompt, 8, eos_token_id=first, arrival_time=0.0)
    _drain(cl)
    assert r.out_tokens == [first]
    assert cl.metrics_summary()["cluster_handoffs"] == 0
    assert not cl._pending_handoffs and not cl._placed
    cl.close()


# ---------------------------------------------------------------------------
# replica death / re-route (coordinator heartbeat plane)
# ---------------------------------------------------------------------------


def _age_heartbeat(cl, idx):
    """The dead replica's last heartbeat moves past the TTL: the
    coordinator's verdict, without waiting for the wall clock."""
    st = cl.server.state
    with st.lock:
        st.last_heartbeat[cl.replicas[idx].rank] -= 2 * cl.server.ttl


def test_reroute_on_replica_death(model_state, shared_fn):
    """A replica missing heartbeats is reported dead by the coordinator
    (TTL) and its queued and running requests drain to the survivors:
    the completion set equals the submission set, outputs still exact."""
    state, cfg, _ = model_state
    cl = _make_cluster(state, cfg, shared_fn, num_replicas=2,
                       name="cl_death", coordinator=True, ttl=30.0,
                       heartbeat_interval=0.05, policy="load")
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 97, size=10).tolist() for _ in range(6)]
    reqs = [cl.add_request(p, 12, arrival_time=0.0) for p in prompts]
    for _ in range(3):
        cl.step()
        cl._test_clock[0] += 1.0
    victims = [r for r in reqs if r.replica == 1]
    assert victims, "load placement left replica 1 empty; test is vacuous"
    cl.kill_replica(1)
    cl.step()                            # no verdict yet: TTL not lapsed
    assert cl.replicas[1].alive
    _age_heartbeat(cl, 1)
    assert cl.server.dead_ranks() == [cl.replicas[1].rank]
    _drain(cl)
    assert set(cl.finished) == {r.req_id for r in reqs}
    assert any(r.n_reroutes > 0 for r in victims)
    assert cl.metrics_summary()["cluster_reroutes"] >= len(victims)
    for r in reqs:
        assert r.out_tokens == _solo(state, cfg, r.prompt, 12)
    assert cl.replicas[0].alive and not cl.replicas[1].alive
    cl.close()


# ---------------------------------------------------------------------------
# aggregate metrics
# ---------------------------------------------------------------------------


def test_metrics_text_merges_with_replica_label(model_state, shared_fn):
    state, cfg, _ = model_state
    cl = _make_cluster(state, cfg, shared_fn, num_replicas=2,
                       name="cl_prom", coordinator=False)
    for i in range(4):
        cl.add_request([1 + i, 2, 3, 4], 3, arrival_time=0.0)
    _drain(cl)
    text = cl.metrics_text()
    assert 'replica="r0"' in text and 'replica="r1"' in text
    seen_types = []
    current = None
    for line in text.strip().splitlines():
        if line.startswith("# TYPE"):
            current = line.split()[2]
            assert current not in seen_types, f"duplicate TYPE {current}"
            seen_types.append(current)
        else:
            assert 'replica="r' in line, line
            name = line.split("{")[0]
            base = name
            for suf in ("_bucket", "_sum", "_count"):
                if name.endswith(suf):
                    base = name[: -len(suf)]
            assert base == current, (line, current)
    tg = [ln for ln in text.splitlines()
          if ln.startswith("tokens_generated{")]
    assert len(tg) == 2
    cl.close()


def test_metrics_summary_survives_replica_reset(model_state, shared_fn):
    """Counter sums bank a replica's pre-reset epoch: reset_metrics on
    one replica must neither double-count nor lose tokens."""
    state, cfg, _ = model_state
    cl = _make_cluster(state, cfg, shared_fn, num_replicas=2,
                       name="cl_sum", coordinator=False)
    NEW = 4
    for i in range(4):
        cl.add_request([5 + i, 6, 7], NEW, arrival_time=0.0)
    _drain(cl)
    assert cl.metrics_summary()["tokens_generated"] == 4 * NEW
    cl.replicas[0].engine.reset_metrics()
    assert cl.metrics_summary()["tokens_generated"] == 4 * NEW, \
        "reset lost the banked epoch"
    for i in range(4):
        cl.add_request([15 + i, 6, 7], NEW, arrival_time=cl._test_clock[0])
    _drain(cl)
    after = cl.metrics_summary()
    assert after["tokens_generated"] == 8 * NEW, \
        "reset double-counted or dropped an epoch"
    assert after["requests_completed"] == 8
    cl.close()


def test_replicas_share_one_compiled_program(model_state):
    """N identically shaped replicas share ONE built step and one device
    copy of the weights; each engine counts one program on the CPU (on
    the card, its own pool's graphs: tests/test_torch_cuda_kernel.py
    and ``chip_smoke.py`` phase 21)."""
    state, cfg, _ = model_state
    cl = _make_cluster(state, cfg, num_replicas=3, name="cl_share",
                       coordinator=False)
    assert len({id(r.engine._step_fn) for r in cl.replicas}) == 1
    w = "h0.attn.qkv.weight"
    assert len({r.engine.params[w].data_ptr() for r in cl.replicas}) == 1
    cl.add_request([1, 2, 3, 4, 5], 3, arrival_time=0.0)
    _drain(cl)
    for r in cl.replicas:
        assert r.engine.compile_count == 1
    cl.close()


# ---------------------------------------------------------------------------
# the port against the JAX cluster
# ---------------------------------------------------------------------------


def _parity_specs():
    port = ClusterSpec(chip=ChipSpec(**SPEC_NUMBERS))
    jax = JaxClusterSpec(chip=JaxChipSpec(**SPEC_NUMBERS))
    return port, jax


def _record_view(rec):
    return {k: v for k, v in rec.items()
            if k not in ("wall_s", "seq", "predicted_s")}


def _assert_records_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert _record_view(g) == _record_view(w)
        assert g["predicted_s"] == pytest.approx(w["predicted_s"],
                                                 rel=1e-12)


def _protocol(cl):
    return [(e["ev"], e["key"], e.get("epoch")) for e in cl.protocol_log]


@pytest.mark.parametrize("mode", ["replicated", "disaggregated"])
def test_cluster_matches_jax_cluster(model_state, shared_fn, jax_fn, mode):
    """The same trace through the JAX cluster and the port's: equal
    tokens, placements, cluster and summed replica counters, protocol
    events in order, and (disaggregated) handoff records."""
    state, cfg, jstate = model_state
    pspec, jspec = _parity_specs()
    rng = np.random.RandomState(21)
    header = rng.randint(1, 97, size=16).tolist()     # two whole pages
    prompts = [header + rng.randint(1, 97, size=n).tolist()
               for n in (3, 9, 5)] + \
        [rng.randint(1, 97, size=n).tolist() for n in (14, 7, 20)]
    kw = dict(num_replicas=2, mode=mode, num_prefill=1, policy="prefix",
              coordinator=False, max_queue_depth=3)
    runs = {}
    for name, st, c, cls, transport, fn in (
            ("jax", jstate, JaxGPTConfig(**CFG_KW), JaxEngineCluster,
             JaxTransport(jspec), jax_fn),
            ("port", state, cfg, EngineCluster,
             LocalPageTransport(pspec), shared_fn)):
        extra = {"use_kernel": False} if cls is JaxEngineCluster else {}
        cl = _make_cluster(st, c, fn, cls=cls, name=f"par_{mode}_{name}",
                           transport=transport, **kw, **extra)
        # the header's later users arrive once its first has finished
        reqs = [cl.add_request(p, 6, arrival_time=t)
                for p, t in zip(prompts, (0.0, 12.0, 13.0, 0.0, 1.0, 1.0))]
        _drain(cl)
        ms = cl.metrics_summary()
        runs[name] = {
            "tokens": [r.out_tokens for r in reqs],
            "placement": [(r.replica, r.prefill_replica, r.n_reroutes)
                          for r in reqs],
            "counters": {k: ms[k] for k in ms
                         if isinstance(ms[k], float) or k in (
                             "requests_rerouted",)},
            "protocol": _protocol(cl),
            "records": list(cl.transport.records)}
        cl.close()
    jax, port = runs["jax"], runs["port"]
    assert port["tokens"] == jax["tokens"]
    assert port["placement"] == jax["placement"]
    assert port["counters"] == {k: jax["counters"][k]
                                for k in port["counters"]}
    assert set(jax["counters"]) - set(port["counters"]) <= \
        {"host_logit_fetches"}
    assert port["protocol"] == jax["protocol"]
    if mode == "disaggregated":
        _assert_records_equal(port["records"], jax["records"])
    else:
        assert port["counters"]["prefix_cache_hits"] >= 1
        assert not port["records"] and not jax["records"]


def _trace_events(tracer):
    return [(e.name, e.track, e.ph, e.ts, e.dur) for e in tracer.events()]


def test_engine_tracer_matches_jax_engine(model_state, shared_fn, jax_fn):
    """``Engine(tracer=...)``: the same traffic (a chunked prompt, a
    late prefix hit, a preemption) gives the JAX engine's events, in
    order, with the same names, tracks, timestamps and attributes (the
    JAX ``unified_step`` span also carries the analysis plane's
    predictions, item 18).  ``set_tracer`` swaps it live, and the cluster
    names each replica's tracks ``r{i}/...``."""
    state, cfg, jstate = model_state
    header = list(range(1, 17))
    traffic = [(0, header + [40, 41, 42], 10), (0, [5, 6, 7], 12),
               (1, list(range(30, 45)), 10), (14, header + [60], 4)]
    events = {}
    for name, make, tracer in (
            ("jax", lambda tf, tr: JaxEngine(
                jstate, JaxGPTConfig(**CFG_KW), num_pages=7,
                time_fn=tf, tracer=tr, debug=True, use_kernel=False,
                step_fn=jax_fn, name="tr_jax", **SHAPE_KW),
             JaxSpanTracer()),
            ("port", lambda tf, tr: Engine(
                state, cfg, num_pages=7, time_fn=tf, tracer=tr,
                debug=True, device="cpu", step_fn=shared_fn,
                name="tr_port", **SHAPE_KW), SpanTracer())):
        clock = [0.0]
        eng = make(lambda: clock[0], tracer)
        for t, p, n in traffic:
            eng.add_request(p, n, arrival_time=float(t))
        while eng.has_work:
            eng.step()
            clock[0] += 1.0
        assert eng.counters["preemptions"].value >= 1
        assert eng.counters["prefix_cache_hits"].value >= 1
        events[name] = tracer.events()
        eng.set_tracer(None)
        assert not eng.tracer.enabled
    got, want = events["port"], events["jax"]
    assert [(e.name, e.track, e.ph, e.ts, e.dur) for e in got] == \
        [(e.name, e.track, e.ph, e.ts, e.dur) for e in want]
    for g, w in zip(got, want):
        if g.name == "unified_step":
            assert g.attrs["exec"] == "tr_port/unified"
            assert {k: g.attrs[k] for k in ("rows", "tokens")} == \
                {k: w.attrs[k] for k in ("rows", "tokens")}
        else:
            assert g.attrs == w.attrs, g.name
    names = {e.name for e in got}
    assert {"enqueue", "queued", "admit", "running", "prefill_chunk",
            "token", "pack", "unified_step", "preempt", "finish",
            "prefix_cache_hit"} <= names
    # the cluster prefixes each replica's tracks
    tr = SpanTracer()
    cl = _make_cluster(state, cfg, shared_fn, num_replicas=2,
                       name="tr_cl", coordinator=False, tracer=tr,
                       policy="load")
    for i in range(2):
        cl.add_request([3 + i, 4, 5], 2, arrival_time=0.0)
    _drain(cl)
    tracks = {e.track for e in tr.events()}
    assert "router" in tracks
    assert {t.split("/")[0] for t in tracks if "/" in t} == {"r0", "r1"}
    cl.close()


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------


def test_sampled_request_same_under_any_placement(model_state,
                                                  shared_fn):
    """The sampler's bits differ from JAX's by design, so sampled modes
    are held within the port: a sampled request's tokens are the same
    on a monolithic engine, on either replica of a replicated cluster
    and through a disaggregated handoff."""
    state, cfg, _ = model_state
    prompt = [5, 17, 2, 9, 1, 30, 31, 44, 12, 3]
    kw = dict(temperature=0.9, top_p=0.9, seed=11)
    eng = Engine(state, cfg, num_pages=12, device="cpu",
                 step_fn=shared_fn, **SHAPE_KW)
    want = eng.add_request(prompt, 8, **kw)
    eng.run()
    outs = []
    for mode, busy in (("replicated", 0), ("replicated", 1),
                       ("disaggregated", 0)):
        cl = _make_cluster(state, cfg, shared_fn, num_replicas=2,
                           mode=mode, name=f"cl_sampled_{mode}",
                           coordinator=False, policy="load")
        if busy:                         # push the request onto r1
            cl.add_request([7, 7, 7], 6, arrival_time=0.0)
        r = cl.add_request(prompt, 8, arrival_time=0.0, **kw)
        _drain(cl)
        if busy:
            assert r.replica == 1
        outs.append(r.out_tokens)
        cl.close()
    assert all(o == want.out_tokens for o in outs), (outs, want.out_tokens)


def test_default_transport_prices_on_the_h100(model_state):
    """The port's default ClusterSpec is the H100 SXM's datasheet:
    a page stream is priced at NVLink 4's one-way rate (450 GB/s) plus
    the link latency."""
    spec = LocalPageTransport().cluster_spec
    assert spec.chip.name == "h100_sxm"
    assert (spec.chip.peak_flops, spec.chip.hbm_bytes, spec.chip.hbm_bw,
            spec.chip.ici_bw) == (989e12, 80e9, 3.35e12, 450e9)
    rec = LocalPageTransport()._price(3, 3 * 2 ** 20, 0, 1, 0.0)
    assert rec["predicted_s"] == pytest.approx(3 * 2 ** 20 / 450e9 + 1e-6,
                                               rel=1e-12)


def test_shared_step_refuses_another_layout(model_state, shared_fn):
    """``Engine(step_fn=)`` shares a built step only between engines of
    its layout; a page size, batch or config it was not built for, or a
    callable that is no unified step, raises."""
    state, cfg, _ = model_state
    Engine(state, cfg, num_pages=12, device="cpu", step_fn=shared_fn,
           **SHAPE_KW)
    for bad in (dict(SHAPE_KW, page_size=16), dict(SHAPE_KW, max_batch=2)):
        with pytest.raises(ValueError, match="step_fn"):
            Engine(state, cfg, num_pages=12, device="cpu",
                   step_fn=shared_fn, **bad)
    mla = dataclasses.replace(cfg, kv_latent_dim=16)
    with pytest.raises(ValueError, match="step_fn"):
        Engine(state, mla, num_pages=12, device="cpu", step_fn=shared_fn,
               **SHAPE_KW)
    with pytest.raises(ValueError, match="step_fn"):
        Engine(state, cfg, num_pages=12, device="cpu",
               step_fn=lambda *a: None, **SHAPE_KW)
