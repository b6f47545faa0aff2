"""Speculative decoding in the port, on the CPU, against the port's own
non-speculative engine and ``generate`` and against the JAX package.

The weights are built by the JAX model from a seed and carried across
with ``state_from_numpy``; vocab 97, hidden 32, 2 layers, fp32.

- temperature-0 spec output equals non-spec output and solo ``generate``
  under pressure (a small pool: preemption asserted, prefix cache off and
  on, LRU eviction asserted), and the JAX spec engine's tokens and draft
  counters on the same weights;
- sampled spec output equals sampled non-spec output across k, chunk
  size and batching (the verify head draws the row sampler's keyed
  choice);
- a draft equal to the target accepts every draft, one with its head
  negated accepts none, and the output is unchanged either way; EOS in
  the middle of a burst and the ``max_new_tokens`` cap; a verify row
  wider than a chunk (``chunk_size=2, k=3``) is attended whole;
- the compile pin (4 on the CPU: the unified step and the draft's three
  programs), a preempted request re-prefilling its draft, a page
  squeeze shedding drafts before it evicts, the spec metrics and
  ``reset_metrics``; the MLA spec engine against the MLA non-spec one;
- against JAX directly: ``speculative_verify_head`` (``accepted`` and
  ``alt`` equal on greedy rows), ``draft_state_from`` (the same keys and
  arrays) and the draft's proposals.

The cluster exposition test of ``tests/test_spec_decode.py`` is ported
here (spec engines as cluster replicas, counters merged).  Not ported:
its rewind-leak lint tests wait for the analysis plane (ROADMAP queue 1
item 18).
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import hetu_tpu as jht
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPTLMHeadModel
from hetu_tpu.models import draft_state_from as jax_draft_state_from
from hetu_tpu.models.gpt import mla_state_from as jax_mla_state_from
from hetu_tpu.serving import Engine as JaxEngine
from hetu_tpu.serving import SpecConfig as JaxSpecConfig
from hetu_tpu.serving.spec import SpecDecoder as JaxSpecDecoder
from hetu_tpu_torch.models import GPTConfig, draft_config, draft_state_from
from hetu_tpu_torch.models.convert import state_from_numpy
from hetu_tpu_torch.models.generate import _Params, generate
from hetu_tpu_torch.ops.ragged_paged_attention import speculative_verify_head
from hetu_tpu_torch.serving import (Engine, PagedKVPool, Request, Scheduler,
                                    SpecConfig)
from hetu_tpu_torch.serving.request import RUNNING
from hetu_tpu_torch.serving.spec import SpecDecoder

jax_rpa = importlib.import_module("hetu_tpu.ops.ragged_paged_attention")

CFG_KW = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=64, sp=False, dropout=0.0)
LEARNED = dict(position="learned", norm="layernorm", activation="gelu",
               **CFG_KW)
ROTARY = dict(position="rotary", norm="rmsnorm", activation="swiglu",
              num_kv_heads=2, **CFG_KW)


def _jax_state(kw, seed):
    jht.set_seed(seed)
    with jht.graph("eager", create_new=True):
        model = JaxGPTLMHeadModel(JaxGPTConfig(**kw))
        model.logits(np.zeros((1, 4), np.int32))
        return {k: np.asarray(v) for k, v in model.state_dict().items()}


def _solo(state, cfg, prompt, n_new):
    return generate(state, cfg, [prompt], n_new,
                    device="cpu")[0, len(prompt):].tolist()


def _make_engine(state, cfg, **kw):
    clock = [0.0]
    kw.setdefault("time_fn", lambda: clock[0])
    kw.setdefault("debug", True)
    eng = Engine(state, cfg, device="cpu", **kw)
    eng._test_clock = clock
    return eng


def _drain(eng):
    guard = 0
    while eng.has_work:
        eng.step()
        eng._test_clock[0] += 1.0
        guard += 1
        assert guard < 500, "engine failed to drain"
        eng.pool.check_invariants()


@pytest.fixture(scope="module")
def gpt():
    """(numpy state, port state, port config, draft state, draft config):
    a learned-position GPT and its 1-layer self-draft."""
    np_state = _jax_state(LEARNED, seed=11)
    cfg = GPTConfig(**LEARNED)
    state = state_from_numpy(np_state, cfg, device="cpu")
    dstate, dcfg = draft_state_from(state, cfg, 1)
    return np_state, state, cfg, dstate, dcfg


# ---------------------------------------------------------------------------
# temperature 0: equal to non-spec, generate and the JAX spec engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefix_cache", [False, True])
def test_spec_temp0_equals_generate_under_pressure(gpt, prefix_cache):
    """A tiny pool (preemption, and with the cache LRU eviction, both
    asserted), staggered arrivals, chunked prefill: every request's
    speculative output is the solo ``generate`` run's."""
    _, state, cfg, dstate, dcfg = gpt
    prompts = [[5, 17, 2, 9, 33, 12, 8, 1], [1, 1, 4, 44],
               [3, 2, 1, 9, 6, 5, 4]]
    want = [_solo(state, cfg, p, 14) for p in prompts]
    eng = _make_engine(state, cfg, num_pages=6, page_size=8, max_batch=4,
                       chunk_size=4, prefix_cache=prefix_cache,
                       spec=SpecConfig(dstate, dcfg, k=3))
    reqs = [eng.add_request(p, 14, arrival_time=float(i))
            for i, p in enumerate(prompts)]
    _drain(eng)
    m = eng.metrics_summary()
    assert m["preemptions"] >= 1, "the trace should preempt"
    if prefix_cache:
        assert m["prefix_cache_evictions"] >= 1
    assert m["spec_accepted"] > 0, "speculation never engaged"
    assert m["spec_accepted"] < m["spec_proposed"], \
        "no rejection: the rewind is untested"
    for r, w in zip(reqs, want):
        assert r.out_tokens == w
    assert eng.pool.used_pages == 0


def test_spec_matches_nonspec_engine_exactly(gpt):
    _, state, cfg, dstate, dcfg = gpt
    rng = np.random.RandomState(2)
    prompts = [[int(t) for t in rng.randint(1, 90, size=n)]
               for n in (23, 4, 17)]
    outs = {}
    for spec in (None, SpecConfig(dstate, dcfg, k=4)):
        eng = _make_engine(state, cfg, num_pages=24, page_size=8,
                           max_batch=4, chunk_size=8, spec=spec)
        reqs = [eng.add_request(p, 8, arrival_time=float(2 * i))
                for i, p in enumerate(prompts)]
        _drain(eng)
        outs[spec is None] = [r.out_tokens for r in reqs]
    assert outs[True] == outs[False]


def _drive(eng, traffic):
    reqs = [eng.add_request(p, n, arrival_time=float(t))
            for t, p, n in traffic]
    while eng.has_work:
        eng.step()
        eng._test_clock[0] += 1.0
    return [r.out_tokens for r in reqs]


def test_spec_engine_matches_jax_spec_engine(gpt):
    """The same weights, self-draft and mixed traffic (a prompt longer
    than a chunk, a late arrival, a preemption, a prefix-cache hit)
    through the JAX spec engine and the port's: equal greedy tokens and
    equal draft counters (the drafts themselves agree)."""
    np_state, state, cfg, dstate, dcfg = gpt
    header = [5, 17, 2, 9, 33, 12, 8, 1]
    traffic = [(0, header + [3, 2, 1, 9, 6, 5, 4, 7, 7], 9),
               (0, [1, 1, 4, 44], 12), (2, [3, 2, 1, 9, 6, 5, 4], 10),
               (14, header + [40, 41], 7)]
    kw = dict(num_pages=7, page_size=8, max_batch=3, chunk_size=4,
              debug=True)
    jcfg = JaxGPTConfig(**LEARNED)
    jd_state, jd_cfg = jax_draft_state_from(np_state, jcfg, 1)
    clock = [0.0]
    jeng = JaxEngine(np_state, jcfg, time_fn=lambda: clock[0],
                     use_kernel=False,
                     spec=JaxSpecConfig(jd_state, jd_cfg, k=3), **kw)
    jeng._test_clock = clock
    jout = _drive(jeng, traffic)
    peng = _make_engine(state, cfg, spec=SpecConfig(dstate, dcfg, k=3),
                        **kw)
    pout = _drive(peng, traffic)
    assert pout == jout
    assert pout == [_solo(state, cfg, p, n) for _, p, n in traffic]
    for name in ("spec_proposed", "spec_accepted", "spec_bonus_tokens",
                 "preemptions", "prefix_cache_hits", "tokens_generated"):
        assert peng.counters[name].value == jeng.counters[name].value, name
    assert peng.counters["preemptions"].value >= 1
    assert peng.counters["spec_accepted"].value > 0


# ---------------------------------------------------------------------------
# sampled mode
# ---------------------------------------------------------------------------

def test_sampled_mode_equal_across_k_chunk_and_batching(gpt):
    """A sampled verify position accepts iff the draft equals the row
    sampler's ``(seed, index)``-keyed choice there, so sampled spec output
    is the non-spec sampled output for every k, chunk size and batch."""
    _, state, cfg, dstate, dcfg = gpt
    prompt = [5, 17, 2, 9, 1]
    ref = None
    configs = [(None, dict(chunk_size=8, max_batch=2))]
    for k in (1, 3):
        configs += [(SpecConfig(dstate, dcfg, k=k),
                     dict(chunk_size=4, max_batch=4)),
                    (SpecConfig(dstate, dcfg, k=k),
                     dict(chunk_size=8, max_batch=2))]
    accepted = 0
    for spec, kw in configs:
        eng = _make_engine(state, cfg, num_pages=16, page_size=8,
                           spec=spec, **kw)
        if kw["max_batch"] == 4:            # mixed greedy/sampled batch
            eng.add_request([3, 2, 1], 8, arrival_time=0.0)
        req = eng.add_request(prompt, 8, temperature=0.7, top_p=0.9,
                              top_k=40, seed=123, arrival_time=0.0)
        _drain(eng)
        accepted += eng.counters["spec_accepted"].value
        if ref is None:
            ref = list(req.out_tokens)
        assert list(req.out_tokens) == ref, (spec and spec.k, kw)
    assert accepted > 0


# ---------------------------------------------------------------------------
# degenerate drafts, commit caps, the verify width
# ---------------------------------------------------------------------------

def test_all_accepted_draft_equals_target(gpt):
    """Draft == target: every burst commits k + 1 tokens, acceptance
    stays 1.0 over several chained bursts (the warm-up feed keeps the
    draft cache seamless), output equal to generate."""
    _, state, cfg, _, _ = gpt
    eng = _make_engine(state, cfg, num_pages=24, page_size=8, max_batch=2,
                       chunk_size=8, spec=SpecConfig(dict(state), cfg, k=4))
    assert eng.spec.own_bytes == 0      # the draft reuses every tensor
    req = eng.add_request([5, 17, 2, 9], 21, arrival_time=0.0)
    _drain(eng)
    m = eng.metrics_summary()
    assert req.out_tokens == _solo(state, cfg, [5, 17, 2, 9], 21)
    assert m["spec_accepted"] == m["spec_proposed"] > 0
    assert m["spec_accept_rate"] == 1.0
    assert m["accepted_per_step"] > 1.0


def test_all_rejected_draft_still_equal(gpt):
    """A head-negated draft proposes the target's argmin: every verify
    emits exactly its bonus token, and the output is unchanged."""
    _, state, cfg, _, _ = gpt
    head = [k for k in state if "lm_head" in k][0]
    neg = dict(state)
    neg[head] = -state[head]
    eng = _make_engine(state, cfg, num_pages=24, page_size=8, max_batch=2,
                       chunk_size=8, spec=SpecConfig(neg, cfg, k=4))
    # only the negated head is the draft's own upload
    assert eng.spec.own_bytes == state[head].numel() * 4
    req = eng.add_request([5, 17, 2, 9], 9, arrival_time=0.0)
    _drain(eng)
    m = eng.metrics_summary()
    assert req.out_tokens == _solo(state, cfg, [5, 17, 2, 9], 9)
    assert m["spec_accepted"] == 0 and m["spec_proposed"] > 0
    # every token but the first (the prefill's) and the last (a plain
    # decode: nothing left to draft) is a bonus token
    assert m["spec_bonus_tokens"] == len(req.out_tokens) - 2


def test_eos_mid_burst_and_max_new_cap(gpt):
    _, state, cfg, _, _ = gpt
    prompt = [5, 17, 2, 9]
    w6 = _solo(state, cfg, prompt, 6)
    eng = _make_engine(state, cfg, num_pages=24, page_size=8, max_batch=2,
                       chunk_size=8, spec=SpecConfig(dict(state), cfg, k=4))
    req = eng.add_request(prompt, 6, eos_token_id=w6[2], arrival_time=0.0)
    _drain(eng)
    assert req.out_tokens == w6[:3]
    eng = _make_engine(state, cfg, num_pages=24, page_size=8, max_batch=2,
                       chunk_size=8, spec=SpecConfig(dict(state), cfg, k=4))
    req = eng.add_request(prompt, 2, arrival_time=0.0)
    _drain(eng)
    assert req.out_tokens == w6[:2]


def test_verify_row_wider_than_a_chunk_is_attended_whole(gpt):
    """chunk_size=2 with k=3: verify rows of up to 4 tokens.  The step
    attends max(chunk, k + 1) tokens a row, and the output equals
    generate; a step that attends only ``chunk`` tokens a row does
    not."""
    _, state, cfg, _, _ = gpt
    prompt = [5, 17, 2, 9, 33]
    want = _solo(state, cfg, prompt, 12)
    outs = []
    for clamp_to_chunk in (False, True):
        eng = _make_engine(state, cfg, num_pages=24, page_size=8,
                           max_batch=2, chunk_size=2,
                           spec=SpecConfig(dict(state), cfg, k=3))
        assert eng._step_fn.max_q == 4
        if clamp_to_chunk:
            eng._step_fn.max_q = eng._step_fn.chunk
        req = eng.add_request(prompt, 12, arrival_time=0.0)
        _drain(eng)
        outs.append(req.out_tokens)
        if not clamp_to_chunk:
            assert eng.counters["spec_accepted"].value > 0
    assert outs[0] == want
    assert outs[1] != want


# ---------------------------------------------------------------------------
# compile pin, preemption, page squeeze, metrics
# ---------------------------------------------------------------------------

def test_spec_compile_count_pinned_mixed_trace(gpt):
    """Greedy and sampled requests, short and long prompts, late
    arrivals, preemption: the spec engine counts 4 programs on the CPU
    (the unified step and the draft's prefill, propose and insert)."""
    _, state, cfg, dstate, dcfg = gpt
    rng = np.random.RandomState(5)
    eng = _make_engine(state, cfg, num_pages=9, page_size=8, max_batch=4,
                       chunk_size=8, spec=SpecConfig(dstate, dcfg, k=3))
    assert eng.compile_count == 4
    for i in range(9):
        n = int(rng.randint(2, 30))
        pr = [int(t) for t in rng.randint(1, 90, size=n)]
        eng.add_request(pr, int(rng.randint(2, 8)),
                        temperature=0.5 if i % 3 == 0 else 0.0,
                        top_p=0.9 if i % 3 == 0 else 0.0,
                        seed=i, arrival_time=float(i))
    _drain(eng)
    m = eng.metrics_summary()
    assert m["preemptions"] >= 1
    assert m["spec_accepted"] > 0
    assert eng.compile_count == m["compile_count"] == 4
    assert sorted(eng.spec.compiled) == ["draft_insert", "draft_prefill",
                                         "draft_propose"]
    assert len(eng.finished) == 9


def test_preempted_speculating_request_resumes_drafting(gpt):
    """Preemption frees the draft slot; on re-admission the request
    re-prefills its draft cache and keeps speculating, output
    unchanged."""
    _, state, cfg, dstate, dcfg = gpt
    prompt = [5, 17, 2, 9]
    want = _solo(state, cfg, prompt, 16)
    eng = _make_engine(state, cfg, num_pages=16, page_size=8, max_batch=2,
                       chunk_size=8, spec=SpecConfig(dstate, dcfg, k=3))
    req = eng.add_request(prompt, 16, arrival_time=0.0)
    while req.n_generated < 6:
        eng.step()
        eng._test_clock[0] += 1.0
    assert eng.spec.prefills >= 1
    assert eng.spec._valid.get(req.req_id)
    # what Engine.step does for an evicted request, applied directly
    eng.scheduler.preempt(req)
    eng.spec.release(req)
    assert req.req_id not in eng.spec._slot
    eng.running.remove(req)
    eng.queue.push(req)
    pre = eng.spec.prefills
    _drain(eng)
    assert req.n_preemptions == 1
    assert eng.spec.prefills == pre + 1
    assert req.out_tokens == want


def test_page_squeeze_sheds_drafts_before_eviction():
    """A burst that needs an extra page is shed (the request degrades
    to a plain decode) rather than funded by evicting anyone."""
    pool = PagedKVPool(1, 4, 4, 1, 4, device="cpu")
    sched = Scheduler(pool, max_batch=2, chunk=4, prefill_rows=1)
    sched.verify_slots, sched.spec_width = 2, 4
    assert sched.token_budget == 2 + 4 + 2 * 4
    pa, pb = pool.alloc(2), pool.alloc(1)      # free list now empty
    a = Request(req_id=0, prompt=[1] * 7, max_new_tokens=8)
    a.tokens, a.pos, a.pages = [1] * 8, 7, pa   # decode fits 2 pages...
    a.spec_drafts = [2, 3, 4]                   # ...the burst needs 3
    b = Request(req_id=1, prompt=[1] * 3, max_new_tokens=4,
                arrival_time=1.0)
    b.tokens, b.pos, b.pages = [1] * 4, 3, pb
    a.state = b.state = RUNNING
    kept, evicted = sched.ensure_decode_pages([a, b])
    assert evicted == [] and a.spec_drafts == []
    assert kept == [a, b] and a.pages == pa and b.pages == pb
    # a staged request takes a verify slot; the shed one its decode slot
    b.spec_drafts = [5, 6]
    rows = sched.pack([a, b])
    assert sorted(rows, key=lambda r: r[2]) == [(a, 1, 0), (b, 3, 3)]
    assert sched.slot_mix(rows) == {
        "decode_slots": 1, "chunk_slots": 0, "verify_slots": 1,
        "spec_tokens": 2, "tokens": 4, "token_budget": 14, "chunk": 4,
        "prefill_rows": 1}
    sched.preempt(b)
    assert b.spec_drafts == [] and b.pages == []


def test_spec_metrics_and_reset(gpt):
    _, state, cfg, dstate, dcfg = gpt
    eng = _make_engine(state, cfg, num_pages=16, page_size=8, max_batch=2,
                       chunk_size=8, spec=SpecConfig(dstate, dcfg, k=3))
    eng.add_request([5, 17, 2, 9], 8, arrival_time=0.0)
    _drain(eng)
    m = eng.metrics_summary()
    assert m["spec_proposed"] > 0
    assert 0.0 <= m["spec_accept_rate"] <= 1.0
    assert m["accepted_per_step"] > 0
    text = eng.metrics_text()
    for name in ("spec_proposed", "spec_accepted", "spec_bonus_tokens"):
        assert name in text
    eng.reset_metrics()
    m = eng.metrics_summary()
    assert m["spec_proposed"] == m["spec_accepted"] == 0
    assert m["spec_bonus_tokens"] == m["tokens_generated"] == 0
    assert m["spec_accept_rate"] == 0.0 and m["accepted_per_step"] == 0.0
    assert eng.steps == eng.executable_calls == 0
    assert m["compile_count"] == 4          # lifetime state: not reset
    assert m["kv_bytes_per_token"] == eng.pool.kv_bytes_per_token


def test_spec_counters_in_cluster_merged_exposition(gpt):
    """The cluster plane passes spec straight through: counters sum in
    metrics_summary and appear per replica in the merged Prometheus
    exposition; a replica reset zeroes its samples while the cluster sum
    banks the pre-reset epoch."""
    from hetu_tpu_torch.serving import EngineCluster
    _, state, cfg, dstate, dcfg = gpt
    clock = [0.0]
    cl = EngineCluster(state, cfg, num_replicas=2, name="spec_cl_t",
                       num_pages=16, page_size=8, max_batch=4,
                       chunk_size=8, time_fn=lambda: clock[0],
                       ttl=3600.0, spec=SpecConfig(dstate, dcfg, k=3),
                       device="cpu")
    try:
        r1 = cl.add_request([5, 17, 2, 9, 1, 4, 8], max_new_tokens=6)
        r2 = cl.add_request([3, 2, 1, 9], max_new_tokens=6)
        guard = 0
        while cl.has_work:
            cl.step()
            clock[0] += 1.0
            guard += 1
            assert guard < 200
        for r in (r1, r2):
            assert r.out_tokens == _solo(state, cfg, r.prompt, 6)
        ms = cl.metrics_summary()
        assert ms["spec_proposed"] > 0
        text = cl.metrics_text()
        assert "spec_proposed" in text and 'replica="r0"' in text
        for rep in cl.replicas:
            rep.engine.reset_metrics()
            assert rep.engine.metrics_summary()["spec_proposed"] == 0
        for line in cl.metrics_text().splitlines():
            if line.startswith("spec_proposed{"):
                assert line.rstrip().endswith(" 0")
        assert cl.metrics_summary()["spec_proposed"] == \
            ms["spec_proposed"]
    finally:
        cl.close()


class _Fixed:
    """A spec engine's step run as the fixed-shape body the card
    captures; records the live masks (the graphs' keys) it saw."""

    def __init__(self, step):
        self.step, self.keys = step, set()

    def __call__(self, params, *arrays):
        self.keys.add(self.step._live(arrays[4]))
        return self.step.fixed(params, *arrays)

    @property
    def compile_count(self):
        return self.step.compile_count


def test_fixed_shape_spec_body_gives_the_eager_tokens(gpt):
    """The body the card captures (live regions at full width, the
    verify head only where the verify region is live, the sampled head
    on every row) gives the eager spec step's tokens on mixed greedy and
    sampled traffic, under all four live masks of ``prefill_rows=1``."""
    _, state, cfg, dstate, dcfg = gpt
    rng = np.random.RandomState(4)
    traffic = [([int(t) for t in rng.randint(1, 90, size=n)], m)
               for n, m in ((20, 9), (5, 7), (13, 2))]
    outs, keys = [], None
    for fixed in (False, True):
        eng = _make_engine(state, cfg, num_pages=24, page_size=8,
                           max_batch=3, chunk_size=8,
                           spec=SpecConfig(dstate, dcfg, k=3))
        if fixed:
            eng._step_fn = _Fixed(eng._step_fn)
        reqs = [eng.add_request(p, m, temperature=0.8 if i == 1 else 0.0,
                                top_p=0.9, seed=3,
                                arrival_time=float(3 * i))
                for i, (p, m) in enumerate(traffic)]
        _drain(eng)
        outs.append([r.out_tokens for r in reqs])
        if fixed:
            keys = eng._step_fn.keys
    assert outs[0] == outs[1]
    assert keys == {(False, False), (True, False), (False, True),
                    (True, True)}


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def test_latent_spec_equals_nonspec_engine():
    """An MLA target and its MLA self-draft: verify rows ride the latent
    step, and greedy and sampled outputs equal the non-spec latent
    engine's."""
    np_state = _jax_state(LEARNED, seed=3)
    jl, jlcfg = jax_mla_state_from(np_state, JaxGPTConfig(**LEARNED),
                                   kv_latent_dim=16)
    lcfg = GPTConfig(**dataclasses.asdict(jlcfg))
    lstate = state_from_numpy(jl, lcfg, device="cpu")
    dstate, dcfg = draft_state_from(lstate, lcfg, 1)
    assert dcfg.is_mla
    rng = np.random.RandomState(2)
    prompts = [[int(t) for t in rng.randint(1, 90, size=n)]
               for n in (23, 4, 17)]
    outs = {}
    for spec in (None, SpecConfig(dstate, dcfg, k=3)):
        eng = _make_engine(lstate, lcfg, num_pages=24, page_size=8,
                           max_batch=4, chunk_size=8, spec=spec)
        reqs = [eng.add_request(p, 8, arrival_time=float(2 * i))
                for i, p in enumerate(prompts)]
        sampled = eng.add_request(prompts[0], 8, temperature=0.7,
                                  top_p=0.9, top_k=40, seed=123,
                                  arrival_time=1.0)
        _drain(eng)
        if spec is not None:
            assert eng.metrics_summary()["spec_accepted"] > 0
        outs[spec is None] = [r.out_tokens for r in reqs] + \
            [sampled.out_tokens]
    assert outs[True] == outs[False]


# ---------------------------------------------------------------------------
# the pieces against JAX
# ---------------------------------------------------------------------------

def test_verify_head_matches_jax_on_greedy_rows():
    """Greedy rows with drafts that match the argmax for 0..K positions,
    spec lens 0..K: ``accepted`` and ``alt`` equal to JAX's."""
    rng = np.random.RandomState(0)
    r, k, v = 6, 4, 97
    logits = rng.randn(r, k, v).astype(np.float32)
    best = logits.argmax(-1).astype(np.int32)
    draft = rng.randint(0, v, (r, k)).astype(np.int32)
    for row in range(r):
        draft[row, :min(row, k)] = best[row, :min(row, k)]
    spec_lens = np.array([4, 4, 2, 4, 0, 3], np.int32)
    ctx = np.array([10, 20, 7, 9, 5, 40], np.int32)
    zf, zi = np.zeros(r, np.float32), np.zeros(r, np.int32)
    seeds = np.arange(r, dtype=np.int32)
    jacc, jalt = jax_rpa.speculative_verify_head(
        logits, draft, spec_lens, zf, zf, zi, seeds, ctx)
    t = torch.from_numpy
    acc, alt = speculative_verify_head(
        t(logits), t(draft), t(spec_lens), t(zf), t(zf), t(zi), t(seeds),
        t(ctx), sampled=False)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(alt.numpy(), np.asarray(jalt))
    assert acc.tolist() == [0, 1, 2, 3, 0, 3]


@pytest.mark.parametrize("layers", [1, 2])
def test_draft_state_from_matches_jax(gpt, layers):
    np_state, state, cfg, _, _ = gpt
    jstate, jcfg = jax_draft_state_from(np_state, JaxGPTConfig(**LEARNED),
                                        layers)
    pstate, pcfg = draft_state_from(state, cfg, layers)
    # the port's state carries the normalised names
    jstate = {_Params._norm(k): v for k, v in jstate.items()}
    assert sorted(pstate) == sorted(jstate)
    for k in pstate:
        assert pstate[k] is state[k]        # references, not copies
        np.testing.assert_array_equal(pstate[k].numpy(),
                                      np.asarray(jstate[k]))
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert pcfg == draft_config(cfg, layers)
    with pytest.raises(ValueError, match="draft num_layers"):
        draft_config(cfg, 3)


@pytest.mark.parametrize("kw", [LEARNED, ROTARY], ids=["learned", "rotary"])
def test_draft_proposals_match_jax(kw):
    """The draft decoders of both packages, from the same weights, stage
    the same requests (one fresh, one after a burst): equal drafts."""
    np_state = _jax_state(kw, seed=5)
    jcfg, cfg = JaxGPTConfig(**kw), GPTConfig(**kw)
    jd, jdc = jax_draft_state_from(np_state, jcfg, 1)
    state = state_from_numpy(np_state, cfg, device="cpu")
    pd, pdc = draft_state_from(state, cfg, 1)
    jdec = JaxSpecDecoder(JaxSpecConfig(jd, jdc, k=3), jcfg, 3, 48, 3)
    pdec = SpecDecoder(SpecConfig(pd, pdc, k=3), cfg, 3, 48, 3,
                       device="cpu")
    reqs = [Request(req_id=i, prompt=p, max_new_tokens=8)
            for i, p in enumerate(([5, 17, 2, 9, 33], [1, 4, 44],
                                   [8] * 20))]
    k_effs = {0: 3, 1: 2, 2: 3}
    for _ in range(2):
        jout = jdec.stage(reqs, k_effs)
        pout = pdec.stage(reqs, k_effs)
        assert pout == jout
        for r in reqs:                   # commit the drafts and go on
            r.tokens = r.tokens + pout[r.req_id] + [7]
    assert pdec.prefills == jdec.prefills == 3
    pdec.release(reqs[1])
    assert reqs[1].req_id not in pdec._slot and len(pdec._free) == 1
