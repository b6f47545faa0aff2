"""The port's trace exporters and op profiler against the JAX package's,
on the CPU.

- a traced port engine's spans (a chunked prompt, a prefix hit, a
  preemption) and a traced training run's (``train_step`` with ``feed``,
  ``executable`` and ``commit`` children, a step each) export to Chrome
  trace JSON that JAX's ``validate_chrome_trace`` passes as well as the
  port's; both packages' exporters give the same document, the same JSONL
  records, the same ``request_timelines`` and ``timeline_summary`` on the
  same span list; the JAX engine's timelines name the same lifecycle;
- ``OpProfiler`` records every op of the tiny GPT's forward (and its
  backward as one ``gradients`` record) and sums as JAX's
  tests/test_profiler.py expects; its computing ops, their order and
  shapes are the JAX profiler's, and the replayed loss and gradients
  equal ``graph.run``'s and the JAX graph's.
"""
import json

import numpy as np
import pytest
import torch

import hetu_tpu as jht
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPTLMHeadModel
from hetu_tpu.obs import export as jexport
from hetu_tpu.obs.tracer import SpanTracer as JaxSpanTracer
from hetu_tpu.serving import Engine as JaxEngine
from hetu_tpu.utils import OpProfiler as JaxOpProfiler
import hetu_tpu_torch as ht
from hetu_tpu_torch import obs, optim
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
from hetu_tpu_torch.models.convert import load_state, state_from_numpy
from hetu_tpu_torch.serving import Engine
from hetu_tpu_torch.utils import OpProfiler

CFG_KW = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=64, sp=False, dropout=0.0)
ENGINE_KW = dict(num_pages=7, page_size=8, max_batch=4, chunk_size=8,
                 prefill_rows=1, max_model_len=56, debug=True)
HEADER = list(range(1, 17))
TRAFFIC = [(0, HEADER + [40, 41, 42], 10), (0, [5, 6, 7], 12),
           (1, list(range(30, 45)), 10), (14, HEADER + [60], 4)]


def _jax_state(cfg_kw, seed=3):
    jht.set_seed(seed)
    with jht.graph("eager", create_new=True):
        model = JaxGPTLMHeadModel(JaxGPTConfig(**cfg_kw))
        model.logits(np.zeros((1, 4), np.int32))
        return {k: np.asarray(v) for k, v in model.state_dict().items()}


def _serve(make):
    clock = [0.0]
    eng = make(lambda: clock[0])
    for t, p, n in TRAFFIC:
        eng.add_request(p, n, arrival_time=float(t))
    while eng.has_work:
        eng.step()
        clock[0] += 1.0
    return eng


@pytest.fixture(scope="module")
def served():
    state = _jax_state(CFG_KW)
    ptr, jtr = obs.SpanTracer(), JaxSpanTracer()
    peng = _serve(lambda tf: Engine(
        state_from_numpy(state, GPTConfig(**CFG_KW), device="cpu"),
        GPTConfig(**CFG_KW), time_fn=tf, tracer=ptr, device="cpu",
        name="exp_port", **ENGINE_KW))
    jeng = _serve(lambda tf: JaxEngine(
        state, JaxGPTConfig(**CFG_KW), time_fn=tf, tracer=jtr,
        use_kernel=False, name="exp_jax", **ENGINE_KW))
    assert peng.counters["preemptions"].value >= 1
    assert peng.counters["prefix_cache_hits"].value >= 1
    return ptr.events(), jtr.events()


def test_engine_trace_validates_in_both_packages(served, tmp_path):
    events, _ = served
    path = str(tmp_path / "serve.json")
    doc = obs.write_chrome_trace(events, path)
    with open(path) as f:
        on_disk = json.load(f)
    assert on_disk == doc
    obs.validate_chrome_trace(on_disk)
    jexport.validate_chrome_trace(on_disk)
    assert doc == jexport.chrome_trace(events)
    tracks = {e["args"]["name"] for e in doc["traceEvents"]
              if e["name"] == "thread_name"}
    assert "engine" in tracks and any(t.startswith("req ") for t in tracks)


def test_jsonl_journal_equals_jax_s(served, tmp_path):
    events, _ = served
    assert obs.events_to_jsonl(events) == jexport.events_to_jsonl(events)
    path = str(tmp_path / "serve.jsonl")
    obs.write_jsonl(events, path)
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == len(events)
    assert [r["name"] for r in rows] == [e.name for e in events]


def test_request_timelines_equal_jax_s(served):
    events, jevents = served
    got = obs.request_timelines(events)
    want = jexport.request_timelines(events)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid in got:
        assert [id(e) for e in got[rid]] == [id(e) for e in want[rid]]
    assert obs.timeline_summary(events) == jexport.timeline_summary(events)
    # the JAX engine's own trace tells the same lifecycles
    jt = jexport.request_timelines(jevents)
    for rid in got:
        assert [e.name for e in got[rid]] == [e.name for e in jt[rid]], rid
    assert obs.timeline_summary(events) == jexport.timeline_summary(jevents)


def _train_graph(state, micro=2):
    with ht.graph("define_and_run", create_new=True, device="cpu",
                  seed=0) as g:
        ids = ht.placeholder("int32", (4, 16), name="ids")
        labels = ht.placeholder("int32", (4, 16), name="labels")
        model = GPTLMHeadModel(GPTConfig(**{**CFG_KW, "max_seq_len": 16}))
        loss = model(ids, labels)
        op = optim.AdamOptimizer(lr=1e-3).minimize(loss)
    load_state(model, state)
    x = np.random.RandomState(0).randint(0, 97, (4, 16)).astype(np.int32)
    return g, loss, op, {ids: x, labels: np.roll(x, -1, 1)}


def test_training_trace_has_a_step_span_a_run(tmp_path):
    state = _jax_state({**CFG_KW, "max_seq_len": 16})
    g, loss, op, feed = _train_graph(state)
    tracer = obs.SpanTracer()
    obs.install_tracer(tracer)
    try:
        for _ in range(3):
            g.run(loss, [loss, op], feed, num_micro_batches=2)
        g.run([loss], feed_dict=feed, run_level="compute_only")
    finally:
        obs.install_tracer(None)
    events = tracer.events()
    steps = [e for e in events if e.name == "train_step"]
    assert len(steps) == 3 and [e for e in events if e.name == "forward"]
    for s in steps:
        kids = [e for e in events if e.parent == "train_step" and
                s.ts <= e.ts and e.end_ts <= s.end_ts]
        assert [e.name for e in kids] == ["feed", "executable", "commit"]
        assert all(not e.attrs["captured"] for e in kids
                   if e.name == "executable")
    doc = obs.write_chrome_trace(events, str(tmp_path / "train.json"))
    obs.validate_chrome_trace(doc)
    jexport.validate_chrome_trace(doc)
    assert tracer.open_count() == 0
    # tracing off: nothing recorded, the run unchanged
    n = len(tracer.events())
    g.run(loss, [loss, op], feed, num_micro_batches=2)
    assert len(tracer.events()) == n


# ---------------------------------------------------------------------------
# the op profiler (tests/test_profiler.py:34-72)
# ---------------------------------------------------------------------------

PROF_KW = dict(vocab_size=32, hidden_size=16, num_layers=2, num_heads=2,
               max_seq_len=8, dtype="float32")


def _tiny_graphs():
    state = _jax_state(PROF_KW)
    rng = np.random.RandomState(0)
    x = rng.randint(0, 32, (2, 8)).astype(np.int32)
    y = rng.randint(0, 32, (2, 8)).astype(np.int32)
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        ids = ht.placeholder("int32", (2, 8), name="ids")
        labels = ht.placeholder("int32", (2, 8), name="labels")
        model = GPTLMHeadModel(GPTConfig(**PROF_KW))
        loss = model(ids, labels)
    load_state(model, state)
    with jht.graph("define_and_run", create_new=True) as jg:
        jids = jht.placeholder("int32", (2, 8), name="ids")
        jlabels = jht.placeholder("int32", (2, 8), name="labels")
        jmodel = JaxGPTLMHeadModel(JaxGPTConfig(**PROF_KW))
        jloss = jmodel(jids, jlabels)
        jmodel.load_state_dict(state)
    return (g, loss, {ids: x, labels: y}), (jg, jloss, {jids: x, jlabels: y})


# ops that only slice or restate a layout: the JAX graph splits and merges
# heads with getitem/reshape under sharding constraints, the port with one
# qkv_heads/merge_heads op; the port's cross entropy keeps the tokens'
# losses and reduces them (over dp too) in the op after it
JAX_LAYOUT_OPS = ("sharding_constraint", "getitem", "reshape")
PORT_LAYOUT_OPS = ("getitem", "qkv_heads", "merge_heads", "dp_loss_reduce")


def _compute_ops(records, layout_ops):
    return [(r["op_type"], r["out_shapes"]) for r in records
            if r["op_type"] not in layout_ops]


def test_op_profiler_records_every_op():
    (g, loss, feed), (jg, jloss, jfeed) = _tiny_graphs()
    prof = OpProfiler(g)
    records = prof.profile([loss], feed, warmup=0, iters=1)
    assert len(records) > 10
    types = {r["op_type"] for r in records}
    assert "matmul" in types or "linear" in types
    assert all(r["time"] >= 0 for r in records)
    assert prof.total() > 0
    by_type = prof.by_type()
    assert abs(sum(by_type.values()) - prof.total()) < 1e-9
    assert prof.by_group(depth=1)
    s = prof.summary(top=5)
    assert "total" in s and "ms" in s
    # every op of the forward the plan runs is replayed once
    plan = [n for n in g._topo_from([loss])
            if n.op_type not in ("placeholder", "variable", "constant")]
    assert len(records) == len(plan)
    # the JAX profiler replays the same computing ops, in the same order,
    # to the same shapes
    jprof = JaxOpProfiler(jg)
    jrec = jprof.profile([jloss], jfeed, warmup=0, iters=1)
    ours = _compute_ops(records, PORT_LAYOUT_OPS)
    theirs = _compute_ops(jrec, JAX_LAYOUT_OPS)
    assert len(ours) > 20
    assert ours[:-1] == theirs[:-1]
    assert ours[-1] == ("softmax_cross_entropy", [(2, 8)])
    assert theirs[-1] == ("softmax_cross_entropy", [()])
    assert records[-1]["op_type"] == "dp_loss_reduce"
    assert records[-1]["out_shapes"] == [()]
    heads = [r["out_shapes"] for r in records if r["op_type"] == "qkv_heads"]
    jheads = [r["out_shapes"][0] for r in jrec if r["op_type"] == "reshape"
              and len(r["out_shapes"][0]) == 4]
    assert [s for trio in heads for s in trio] == jheads
    # the replay computes what the graph computes
    replayed = float(prof.values[loss.id])
    (ran,) = g.run(loss, [loss], feed)
    (jran,) = jg.run(jloss, [jloss], jfeed)
    assert abs(replayed - float(ran)) <= 1e-5
    assert abs(replayed - float(np.asarray(jran))) <= 1e-5


def test_op_profiler_replays_the_backward_as_run_does():
    """Fetching the gradients replays the backward as one ``gradients``
    record of the parameters' shapes, after the forward's ops."""
    (g, loss, feed), (jg, jloss, jfeed) = _tiny_graphs()
    xs = g.trainable_variables
    grads = g.make_gradients(loss, xs)
    prof = OpProfiler(g)
    records = prof.profile([loss] + grads, feed, warmup=1, iters=2)
    assert records[-1]["op_type"] == "gradients"
    assert records[-1]["out_shapes"] == [tuple(x.shape) for x in xs]
    assert [r["op_type"] for r in records].count("gradients") == 1
    assert prof.by_type()["gradients"] > 0
    # the replayed backward gives g.run's gradients and the JAX graph's
    ran = g.run(loss, grads, feed)
    jxs = jg.trainable_variables
    jgrads = jg.make_gradients(jloss, jxs)
    jran = dict(zip([x.name for x in jxs], jg.run(jloss, jgrads, jfeed)))
    assert sorted(jran) == sorted(x.name for x in xs)
    for x, gt, r in zip(xs, grads, ran):
        replayed = prof.values[gt.id].detach().cpu().numpy()
        np.testing.assert_allclose(replayed, np.asarray(r), rtol=0,
                                   atol=1e-6, err_msg=x.name)
        np.testing.assert_allclose(replayed, np.asarray(jran[x.name]),
                                   rtol=0, atol=1e-5, err_msg=x.name)
