"""The port's compiled steps, on the CPU.

On the card both main paths capture a fixed-shape step once in a CUDA
graph and replay it (``hetu_tpu_torch/core/capture.py``); on the CPU
they stay eager.  These tests run the captured bodies eagerly here, on
the same seeded weights (built by the JAX model, carried across with
``models.convert``):

- serving: the fixed-shape body (live chunk slots at full width, idle
  ones skipped, the sampled head on every row, static buffers) gives the
  eager step's tokens over mixed traffic (idle and live chunk slots,
  padding tails, a prefix-cache hit, a preemption, one sampled row), and
  at temperature 0 the JAX engine's tokens: full-head, MLA, and MLA on
  int8 pages; ``compile_count`` is 1 on the CPU and does not grow;
- training: the step body over the plan's static feed buffers equals
  ``g.run`` bitwise for 3 Adam steps with two micro-batches, and stays
  within 2e-5 of the JAX package's run; Adam's step count lives in a
  tensor, so an optimizer resumed from another's state updates alike;
  ``reset_variable`` keeps a variable's storage;
- the capture module's own logic: the fixed spans, the eager switch, the
  launch counters, the dropout generators, the refused-operation report.

The card tests of the same steps (captured against eager) are in
``tests/test_torch_cuda_kernel.py``; those of the graph layer's plans
are here, marked ``cuda`` (they skip without a card): a captured GRAD
plan and UPDATE plan sharing the gradient accumulator, and one captured
graph a shape bucket.  On a card machine without JAX, ``python -m pytest
--noconftest -m cuda tests/test_torch_compiled_step.py`` runs them alone.
"""
import contextlib
import dataclasses
import importlib

import numpy as np
import pytest
import torch

try:
    import hetu_tpu as jht
    from hetu_tpu import optim as joptim
    from hetu_tpu.models import GPTConfig as JaxGPTConfig
    from hetu_tpu.models import GPTLMHeadModel as JaxGPTLMHeadModel
    from hetu_tpu.models.gpt import mla_state_from as jax_mla_state_from
    JaxEngine = importlib.import_module("hetu_tpu.serving.engine").Engine
except ImportError:     # a card machine without JAX: the cuda cases only
    jht = None
import hetu_tpu_torch as ht
from hetu_tpu_torch import optim
from hetu_tpu_torch.core import capture
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
from hetu_tpu_torch.models.convert import (load_state, state_from_numpy,
                                           state_numpy)
from hetu_tpu_torch.models.generate import _Params
from hetu_tpu_torch.ops import flash_attention as fa
from hetu_tpu_torch.ops import paged_attention as pa
from hetu_tpu_torch.ops import ragged_paged_attention as rpa
from hetu_tpu_torch.serving import Engine
from hetu_tpu_torch.serving.decode import UnifiedStep

CFG_KW = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=64, sp=False, dropout=0.0)
LLAMA = dict(num_kv_heads=2, position="rotary", norm="rmsnorm",
             activation="swiglu", **CFG_KW)
GPT2 = dict(position="learned", norm="layernorm", activation="gelu",
            **CFG_KW)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _jax_state(kw, seed):
    jht.set_seed(seed)
    with jht.graph("eager", create_new=True):
        model = JaxGPTLMHeadModel(JaxGPTConfig(**kw))
        model.logits(np.zeros((1, 4), np.int32))
        return {k: np.asarray(v) for k, v in model.state_dict().items()}


# name -> (base config, seed, MLA latent and rope dims or None, page quant)
SERVING = {"full_head": (LLAMA, 11, None, None),
           "mla": (LLAMA, 7, (16, 4), None),
           "mla_int8": (GPT2, 3, (16, 0), "int8")}


@pytest.fixture(scope="module", params=sorted(SERVING))
def served(request):
    """(name, JAX state, JAX config, port state, port config, quant)."""
    kw, seed, mla, quant = SERVING[request.param]
    jstate, jcfg = _jax_state(kw, seed), JaxGPTConfig(**kw)
    if mla is not None:
        jstate, jcfg = jax_mla_state_from(jstate, jcfg, kv_latent_dim=mla[0],
                                          kv_rope_dim=mla[1])
    pcfg = GPTConfig(**dataclasses.asdict(jcfg))
    return (request.param, jstate, jcfg,
            state_from_numpy(jstate, pcfg, device="cpu"), pcfg, quant)


class _FixedShapes:
    """An engine's step function run as the fixed-shape body the card
    captures; counts the steps with an idle chunk slot and with a live
    one's padding tail."""

    def __init__(self, step: UnifiedStep):
        self.step = step
        self.idle = self.tails = 0

    def __call__(self, params, *arrays):
        q_lens = arrays[4]
        for row, _ in self.step._chunk_starts:
            self.idle += q_lens[row] == 0
            self.tails += 0 < q_lens[row] < self.step.chunk
        return self.step.fixed(params, *arrays)

    @property
    def compile_count(self):
        return self.step.compile_count


HEADER = [5, 17, 2, 9, 33, 12, 8, 1]                  # one whole page
# (arrival step, prompt, new tokens, temperature)
TRAFFIC = [(0, HEADER + [3, 2, 1, 9, 6, 5, 4, 7, 7], 6, 0.0),  # > chunk
           (0, [1, 1, 4, 44], 8, 0.0),
           (2, [3, 2, 1, 9, 6, 5, 4], 8, 0.9),          # late, sampled
           (14, HEADER + [40, 41], 5, 0.0)]              # prefix hit
ENGINE_KW = dict(num_pages=6, page_size=8, max_batch=3, chunk_size=4,
                 debug=True)


def _drive(make_engine, traffic, fixed=False):
    clock = [0.0]
    eng = make_engine(lambda: clock[0])
    if fixed:
        eng._step_fn = _FixedShapes(eng._step_fn)
    reqs = [eng.add_request(p, n, arrival_time=float(t), temperature=temp,
                            top_p=0.9 if temp else 0.0, seed=5)
            for t, p, n, temp in traffic]
    while eng.has_work:
        eng.step()
        clock[0] += 1.0
    return eng, [r.out_tokens for r in reqs]


def _port_engine(served):
    _, _, _, pstate, pcfg, quant = served
    return lambda tf: Engine(pstate, pcfg, time_fn=tf, device="cpu",
                             page_quant=quant, **ENGINE_KW)


def test_fixed_shape_body_gives_the_eager_steps_tokens(served):
    """Mixed traffic with a sampled row: the fixed-shape body's tokens
    equal the eager step's, and the traffic did reach idle chunk slots,
    padding tails, a prefix-cache hit and a preemption."""
    eager_eng, eager = _drive(_port_engine(served), TRAFFIC)
    fixed_eng, fixed = _drive(_port_engine(served), TRAFFIC, fixed=True)
    assert fixed == eager
    assert all(len(t) == n for t, (_, _, n, _) in zip(fixed, TRAFFIC))
    shim = fixed_eng._step_fn
    assert shim.idle > 0 and shim.tails > 0
    for name in ("prefix_cache_hits", "preemptions"):
        assert fixed_eng.counters[name].value >= 1, name
        assert fixed_eng.counters[name].value == \
            eager_eng.counters[name].value, name


def test_fixed_shape_body_at_temperature_zero_equals_jax_engine(served):
    _, jstate, jcfg, _, _, quant = served
    greedy = [(t, p, n, 0.0) for t, p, n, _ in TRAFFIC]
    _, fixed = _drive(_port_engine(served), greedy, fixed=True)
    _, jout = _drive(lambda tf: JaxEngine(
        jstate, jcfg, time_fn=tf, use_kernel=False, page_quant=quant,
        **ENGINE_KW), greedy)
    assert fixed == jout


def test_compile_count_on_the_cpu_is_one_and_stable(served):
    eng, _ = _drive(_port_engine(served), TRAFFIC)
    assert eng.compile_count == 1
    calls = eng.executable_calls
    for t, p, n, temp in TRAFFIC:
        eng.add_request(p, n, temperature=temp, seed=1)
    eng.run()
    assert eng.executable_calls > calls
    assert eng.compile_count == 1
    assert eng.metrics_summary()["compile_count"] == eng.compile_count


@pytest.mark.parametrize("live,want", [
    ((True,), None),
    ((False,), [(0, 3)]),
    ((True, False), [(0, 7)]),
    ((False, True), [(0, 3), (7, 4)]),
    ((True, True), None),
    ((False, False), [(0, 3)])])
def test_fixed_spans_cover_decode_slots_and_live_chunks(live, want):
    cfg = GPTConfig(**LLAMA)
    step = UnifiedStep(cfg, max_seqs=3, chunk=4, prefill_rows=len(live),
                       max_pages=4, page_size=8, device="cpu")
    assert step._fixed_spans(live) == want
    assert step.compile_count == 1


def test_eager_switch_nests_and_restores():
    assert not capture.is_eager()
    with capture.eager():
        assert capture.is_eager()
        with capture.eager():
            assert capture.is_eager()
        assert capture.is_eager()
    assert not capture.is_eager()
    with pytest.raises(KeyError):
        with capture.eager():
            raise KeyError("x")
    assert not capture.is_eager()


def test_every_kernel_wrapper_registers_its_launch_counters():
    registered = {fn: names for fn, names in capture._COUNTERS}
    flash = ("launches", "tensor_core_launches", "tf32_launches",
             "wgmma_launches", "causal_launches")
    want = {fa.flash_fwd_cuda: flash, fa.flash_bwd_fused_cuda: flash,
            fa.flash_bwd_dq_cuda: flash, fa.flash_bwd_dkv_cuda: flash,
            rpa.ragged_paged_attention_cuda: ("launches",),
            rpa.latent_ragged_paged_attention_cuda: ("launches",
                                                     "wgmma_launches"),
            pa.paged_attention_cuda: ("launches",)}
    for fn, names in want.items():
        assert registered.get(fn) == names, fn.__name__
    counts = capture._read_counters()
    assert all((fn, n) in counts for fn, names in want.items()
               for n in names)


def test_a_refused_capture_names_the_line_of_the_port():
    try:
        rpa.ragged_paged_attention_reference(
            torch.zeros(2, 1, 4), torch.zeros(2, 2, 1, 4),
            torch.zeros(2, 2, 1, 4), torch.tensor([1], dtype=torch.int32),
            torch.tensor([0, 1, 2], dtype=torch.int32),
            torch.zeros(1, 2, dtype=torch.int32),
            torch.tensor([1], dtype=torch.int32), max_q=0)
    except ValueError as exc:
        where = capture._where(exc)
    assert where.startswith("hetu_tpu_torch/ops/ragged_paged_attention.py:")
    assert "_check_ragged_shapes" in where
    assert capture._where(RuntimeError("x")) == "outside the port"


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN = {"llama": LLAMA, "gpt2": GPT2}
B, S = 4, 16


def _batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 97, (B, S)).astype(np.int32),
            rng.randint(0, 97, (B, S)).astype(np.int32))


def _port_graph(kw, state, lr=1e-3):
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        ids = ht.placeholder("int32", (B, S), name="input_ids")
        labels = ht.placeholder("int32", (B, S), name="labels")
        model = GPTLMHeadModel(GPTConfig(**kw))
        loss = model(ids, labels)
        opt = optim.AdamOptimizer(lr=lr)
        train_op = opt.minimize(loss)
        load_state(model, state)
    return dict(g=g, ids=ids, labels=labels, model=model, loss=loss,
                train_op=train_op, opt=opt)


def _train(p, x, y, steps=3, static=False):
    losses = []
    for _ in range(steps):
        l, u = p["g"]._run([p["loss"], p["train_op"]],
                           {p["ids"]: x, p["labels"]: y}, 2, None,
                           static=static)
        assert u is None
        losses.append(l.clone())
    return losses


@pytest.mark.parametrize("which", sorted(TRAIN))
def test_step_body_on_static_feeds_equals_run_bitwise_and_jax(which):
    kw = TRAIN[which]
    state = _jax_state(kw, seed=5)
    x, y = _batch(2)
    eager, body = _port_graph(kw, state), _port_graph(kw, state)
    want = _train(eager, x, y)
    got = _train(body, x, y, static=True)
    entry = next(iter(body["g"]._plan_pool.values()))
    assert set(entry.feeds) == {body["ids"].id, body["labels"].id}
    assert len(body["g"]._plan_pool) == 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    pe, pb = state_numpy(eager["model"]), state_numpy(body["model"])
    for name in pe:
        np.testing.assert_array_equal(pb[name], pe[name], err_msg=name)
    # the JAX package's 3 steps from the same weights
    with jht.graph("define_and_run", create_new=True) as jg:
        ids = jht.placeholder("int32", (B, S), name="input_ids")
        labels = jht.placeholder("int32", (B, S), name="labels")
        jmodel = JaxGPTLMHeadModel(JaxGPTConfig(**kw))
        jloss = jmodel(ids, labels)
        jop = joptim.AdamOptimizer(lr=1e-3).minimize(jloss)
        jmodel.load_state_dict(state)
    jl = [float(np.asarray(jg.run(jloss, [jloss, jop], {ids: x, labels: y},
                                  num_micro_batches=2)[0]))
          for _ in range(3)]
    np.testing.assert_allclose([float(v) for v in got], jl, rtol=2e-5)
    jw = {_Params._norm(k): np.asarray(v)
          for k, v in jmodel.state_dict().items()}
    for name in jw:
        np.testing.assert_allclose(pb[name], jw[name], rtol=0, atol=2e-5,
                                   err_msg=name)


def test_adam_step_count_lives_in_a_tensor_and_resumes():
    kw = TRAIN["gpt2"]
    state = _jax_state(kw, seed=6)
    x, y = _batch(3)
    p = _port_graph(kw, state)
    _train(p, x, y, steps=2)
    step = p["opt"]._state["step"]
    assert isinstance(step, torch.Tensor) and float(step) == 2.0
    saved_opt = p["opt"].state_dict()
    saved_w = state_numpy(p["model"])
    _train(p, x, y, steps=1)
    want = state_numpy(p["model"])
    assert float(p["opt"]._state["step"]) == 3.0
    results = {}
    for resume in (True, False):
        load_state(p["model"], saved_w)
        other = optim.AdamOptimizer(lr=1e-3)
        op = other.minimize(p["loss"])
        if resume:
            other.load_state_dict(saved_opt)
        p["g"].run(p["loss"], [p["loss"], op],
                   {p["ids"]: x, p["labels"]: y}, num_micro_batches=2)
        results[resume] = state_numpy(p["model"])
        assert float(other._state["step"]) == (3.0 if resume else 1.0)
    for name in want:
        np.testing.assert_array_equal(results[True][name], want[name],
                                      err_msg=name)
    # a fresh optimizer (step 1's bias correction) moves the weights
    # differently: the resumed count is what made them equal
    assert any(not np.array_equal(results[False][n], want[n]) for n in want)


def test_load_state_dict_copies_into_held_tensors():
    kw = TRAIN["gpt2"]
    p = _port_graph(kw, _jax_state(kw, seed=6))
    x, y = _batch(3)
    _train(p, x, y, steps=1)
    st = p["opt"]._state
    ptrs = [st["step"].data_ptr()] + [m.data_ptr() for m in st["m"].values()]
    saved = p["opt"].state_dict()
    assert saved["step"].data_ptr() != st["step"].data_ptr()
    _train(p, x, y, steps=1)
    p["opt"].load_state_dict(saved)
    assert float(st["step"]) == 1.0
    assert ptrs == [st["step"].data_ptr()] + [m.data_ptr()
                                              for m in st["m"].values()]


def test_reset_variable_keeps_the_storage():
    kw = TRAIN["llama"]
    p = _port_graph(kw, _jax_state(kw, seed=5))
    g = p["g"]
    var = g.trainable_variables[0]
    before = g.get_tensor_value(var)
    ptr = before.data_ptr()
    value = np.full(var.shape, 0.25, np.float32)
    g.reset_variable(var, value)
    after = g.get_tensor_value(var)
    assert after.data_ptr() == ptr and after is before
    assert torch.equal(after, torch.full(var.shape, 0.25))
    with pytest.raises(ValueError, match="shape"):
        g.reset_variable(var, np.zeros((1,), np.float32))


def test_dropout_plans_name_their_generator(monkeypatch):
    kw = dict(TRAIN["gpt2"], dropout=0.1)
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        ids = ht.placeholder("int32", (B, S), name="input_ids")
        labels = ht.placeholder("int32", (B, S), name="labels")
        loss = GPTLMHeadModel(GPTConfig(**kw))(ids, labels)
    x, y = _batch(4)
    (a,) = g.run([loss], feed_dict={ids: x, labels: y})
    (b,) = g.run([loss], feed_dict={ids: x, labels: y})
    assert not torch.equal(a, b)            # fresh masks every run
    entry = next(iter(g._plan_pool.values()))
    monkeypatch.setattr(capture, "can_capture_generators", lambda: True)
    assert g._generators(entry) == [g.generator]
    monkeypatch.setattr(capture, "can_capture_generators", lambda: False)
    with pytest.raises(RuntimeError, match="frozen mask"):
        g._generators(entry)


# ---------------------------------------------------------------------------
# the graph layer's plans on the card (skip without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_trainer(batch=(4, 64), buckets=None, init=None):
    """A tiny fp32 GPT-2 on the card (its weights ``init``, else its own
    from seed 0) with an SGD update op."""
    with ht.graph("define_and_run", create_new=True, device="cuda",
                  seed=0) as g:
        ids = ht.placeholder("int32", batch, name="input_ids")
        labels = ht.placeholder("int32", batch, name="labels")
        model = GPTLMHeadModel(GPTConfig(**GPT2, dtype="float32"))
        loss = model(ids, labels)
        train_op = optim.SGDOptimizer(lr=0.5).minimize(loss)
        if buckets is not None:
            g.set_shape_buckets(buckets, pad_values={labels: -100})
    if init is not None:
        load_state(model, init)
    return g, ids, labels, model, loss, train_op


@pytest.mark.cuda
def test_captured_grad_and_update_plans_share_the_accumulator(cuda_device):
    """3 GRAD runs and an UPDATE, twice over, captured: two CUDA graphs
    (the GRAD plan and the UPDATE plan), the weights of the same runs
    under ``capture.eager()`` bitwise, the weights still during the GRAD
    runs, and the accumulator's storage kept and zeroed by each UPDATE
    replay."""
    rng = np.random.RandomState(6)
    toks = [rng.randint(0, 97, (4, 65)).astype(np.int32) for _ in range(8)]
    init = state_numpy(_card_trainer()[3])
    runs = {}
    for eager in (True, False):
        g, ids, labels, model, loss, op = _card_trainer(init=init)
        ptrs, still = set(), True
        with capture.eager() if eager else contextlib.nullcontext():
            for i, t in enumerate(toks):
                level = "update" if i % 4 == 3 else "grad"
                before = state_numpy(model) if level == "grad" else None
                g.run(loss, [loss, op], {ids: t[:, :-1], labels: t[:, 1:]},
                      run_level=level)
                if before is not None:
                    after = state_numpy(model)
                    still &= all(np.array_equal(before[k], after[k])
                                 for k in before)
                ptrs |= {a.data_ptr() for a in g._grad_accum.values()}
                if level == "update":
                    assert all(float(a.abs().max()) == 0
                               for a in g._grad_accum.values())
        assert still and len(ptrs) == len(g._grad_accum)
        runs[eager] = state_numpy(model), g.compile_count, len(g._plan_pool)
    (want, eg, ep), (got, cg, cp) = runs[True], runs[False]
    assert (eg, ep) == (0, 2) and (cg, cp) == (2, 2)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.cuda
def test_one_captured_graph_a_bucket(cuda_device):
    """A symbolic batch on buckets [2, 4] (labels padded with -100):
    batches 1, 2, 3, 4, 2, 1 capture two graphs, and the losses are the
    eager runs'."""
    rng = np.random.RandomState(7)
    sizes = (1, 2, 3, 4, 2, 1)
    toks = [rng.randint(0, 97, (b, 65)).astype(np.int32) for b in sizes]
    init = state_numpy(_card_trainer()[3])
    runs = {}
    for eager in (True, False):
        batch = (ht.SymbolicDim("batch"), 64)
        g, ids, labels, model, loss, op = _card_trainer(batch, [2, 4], init)
        with capture.eager() if eager else contextlib.nullcontext():
            losses = [float(g.run(loss, [loss, op],
                                  {ids: t[:, :-1], labels: t[:, 1:]})[0])
                      for t in toks]
        shapes = sorted(tuple(b.shape) for e in g._plan_pool.values()
                        for b in e.feeds.values())
        runs[eager] = losses, g.compile_count, shapes
    (want, eg, _), (got, cg, shapes) = runs[True], runs[False]
    assert eg == 0 and cg == 2
    assert shapes == [(2, 64), (2, 64), (4, 64), (4, 64)]
    assert got == want and np.isfinite(got).all()
