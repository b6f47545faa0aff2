"""The port's serving engine against the JAX engine, and its own
invariants, on the CPU.

- Against JAX: the port's ``Engine(device="cpu")`` and the JAX
  ``Engine(use_kernel=False)`` get the same weights (built by the JAX
  model, carried across with ``state_from_numpy``) and the same mixed
  traffic — a prompt longer than ``chunk_size``, a late arrival, a
  preemption under a small pool and a prefix-cache hit — with
  ``debug=True``, so the pool and cache invariants are checked every
  step.  Greedy outputs and the scheduling counters must be equal.
- Inside the port: temperature 0 equals the port's ``generate``; a
  sampled request gives the same tokens whatever the chunk size or
  batch companions; ``top_k=1`` equals greedy.
- Import and device rules: the port and ``chip_smoke.py`` import
  neither JAX nor the JAX package, and ``Engine`` without
  ``device="cpu"`` raises where there is no card.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import hetu_tpu as ht
from hetu_tpu.models import GPTConfig as JaxGPTConfig, GPTLMHeadModel
from hetu_tpu.serving import Engine as JaxEngine
from hetu_tpu_torch.models import GPTConfig
from hetu_tpu_torch.models.convert import random_state, state_from_numpy
from hetu_tpu_torch.models.generate import generate
from hetu_tpu_torch.serving import Engine, PagedKVPool, PrefixCache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG_KW = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
              num_kv_heads=2, max_seq_len=64, sp=False, dropout=0.0,
              position="rotary", norm="rmsnorm", activation="swiglu")


def _build_state(cfg, seed=3):
    ht.set_seed(seed)
    with ht.graph("eager", create_new=True):
        model = GPTLMHeadModel(cfg)
        model.logits(np.zeros((1, 4), np.int32))
        state = {k: np.asarray(v) for k, v in model.state_dict().items()}
    return state


def _drive(make_engine, traffic):
    """Run ``traffic`` [(arrival step, prompt, new tokens)] on a fresh
    engine with a synthetic clock of one second per step."""
    clock = [0.0]
    eng = make_engine(lambda: clock[0])
    reqs = [eng.add_request(p, n, arrival_time=float(t))
            for t, p, n in traffic]
    while eng.has_work:
        eng.step()
        clock[0] += 1.0
    return eng, [r.out_tokens for r in reqs]


def test_engine_matches_jax_engine_on_mixed_traffic():
    state = _build_state(JaxGPTConfig(**CFG_KW), seed=11)
    header = [5, 17, 2, 9, 33, 12, 8, 1]              # one whole page
    traffic = [(0, header + [3, 2, 1, 9, 6, 5, 4, 7, 7], 6),  # > chunk
               (0, [1, 1, 4, 44], 8),
               (2, [3, 2, 1, 9, 6, 5, 4], 8),           # late arrival
               (14, header + [40, 41], 5)]               # prefix hit
    kw = dict(num_pages=6, page_size=8, max_batch=3, chunk_size=4,
              debug=True)
    jeng, jout = _drive(lambda tf: JaxEngine(
        state, JaxGPTConfig(**CFG_KW), time_fn=tf, use_kernel=False,
        **kw), traffic)
    peng, pout = _drive(lambda tf: Engine(
        state_from_numpy(state, GPTConfig(**CFG_KW), device="cpu"),
        GPTConfig(**CFG_KW), time_fn=tf, device="cpu", **kw), traffic)
    assert pout == jout
    for name in ("preemptions", "prefix_cache_hits", "prefill_tokens",
                 "tokens_generated", "step_calls"):
        assert peng.counters[name].value == jeng.counters[name].value, name
    assert peng.counters["preemptions"].value >= 1
    assert peng.counters["prefix_cache_hits"].value >= 1
    assert peng.pool.used_pages == 0


@pytest.fixture(scope="module")
def tiny():
    cfg = GPTConfig(**CFG_KW)
    return cfg, random_state(cfg, seed=4, device="cpu",
                             dtype=torch.float32, std=0.3)


def test_engine_temperature_zero_equals_generate(tiny):
    cfg, st = tiny
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, 90, size=n).tolist() for n in (23, 4, 37)]
    want = [generate(st, cfg, [p], 6, device="cpu")[0, len(p):].tolist()
            for p in prompts]
    for chunk in (4, 16, None):
        _, out = _drive(lambda tf: Engine(
            st, cfg, num_pages=24, page_size=8, max_batch=4,
            chunk_size=chunk, time_fn=tf, device="cpu", debug=True),
            [(0, p, 6) for p in prompts])
        assert out == want, chunk


def test_sampled_request_independent_of_chunking_and_companions(tiny):
    cfg, st = tiny
    prompt = [5, 17, 2, 9, 1, 30, 31]
    runs = []
    for chunk, peers in ((64, [[3, 2, 1], [9, 9]]), (2, [])):
        clock = [0.0]
        eng = Engine(st, cfg, num_pages=16, page_size=8, max_batch=3,
                     chunk_size=chunk, time_fn=lambda: clock[0],
                     device="cpu")
        for p in peers:
            eng.add_request(p, 8, arrival_time=0.0)
        req = eng.add_request(prompt, 8, temperature=0.8, top_p=0.95,
                              top_k=40, seed=7, arrival_time=0.0)
        eng.run()
        runs.append(req.out_tokens)
    assert runs[0] == runs[1]


def test_top_k_one_equals_greedy(tiny):
    cfg, st = tiny
    prompt = [5, 17, 2, 9]
    out = {}
    for temp, k in ((0.0, 0), (1.3, 1)):
        eng = Engine(st, cfg, num_pages=16, page_size=8, max_batch=2,
                     device="cpu")
        req = eng.add_request(prompt, 8, temperature=temp, top_k=k, seed=3)
        eng.run()
        out[temp] = req.out_tokens
    assert out[0.0] == out[1.3]


def test_engine_metrics_and_abort(tiny):
    cfg, st = tiny
    eng = Engine(st, cfg, num_pages=16, page_size=8, max_batch=2,
                 device="cpu", debug=True,
                 latency_buckets=[0.5, 2.0, 8.0])
    eng.add_request([1, 2, 3], 3)
    eng.run()
    m = eng.metrics_summary()
    assert m["requests_completed"] == 1 and m["tokens_generated"] == 3
    assert m["executable_calls"] == m["step_calls"] == eng.executable_calls
    assert m["ttft"]["count"] == 1 and m["tbt_buckets"]["+Inf"] == 2
    assert "# TYPE ttft histogram" in eng.metrics_text()
    eng.add_request([4, 5, 6, 7], 4)
    eng.step()
    assert eng.abort_all() == [1]
    assert not eng.has_work and eng.pool.used_pages == 0


def test_pool_and_cache_invariants_catch_corruption():
    pool = PagedKVPool(1, 6, 4, 2, 8, device="cpu", debug=True)
    cache = PrefixCache(pool)
    pages = pool.alloc(2)
    pool.check_invariants()
    cache.check_invariants()
    pool._free.append(pages[0])                 # both free and allocated
    with pytest.raises(AssertionError, match="page both free and "
                                             "allocated"):
        pool.check_invariants()
    with pytest.raises(ValueError, match="double free"):
        PagedKVPool(1, 4, 4, 2, 8, device="cpu").free([1])


def test_later_slices_are_refused(tiny):
    """The options of later slices (a mesh, the analysis tap) raise
    ``NotImplementedError`` naming their ROADMAP item; MoE configs serve;
    ``host_tier``,
    ``step_fn`` and ``tracer`` are taken (their own tests use them,
    tests/test_torch_slo.py and tests/test_torch_cluster.py); ``name``
    is taken, and ``use_kernel`` only where it names what the device
    runs (the plain versions on the CPU)."""
    cfg, st = tiny
    for kw, item in ((dict(mesh=object()), "item 19"),
                     (dict(analysis_tap=True), "item 18")):
        with pytest.raises(NotImplementedError, match=item):
            Engine(st, cfg, device="cpu", **kw)
    eng = Engine(st, cfg, device="cpu", name="replica0", use_kernel=False,
                 analysis_tap=False)
    assert eng.name == "replica0" and not eng.use_kernel
    assert not Engine(st, cfg, device="cpu").use_kernel
    with pytest.raises(ValueError, match="use_kernel"):
        Engine(st, cfg, device="cpu", use_kernel=True)
    eng.set_tracer(None)                    # follows the ambient tracer
    assert not eng.tracer.enabled
    with pytest.raises(TypeError, match="SpecConfig"):
        Engine(st, cfg, device="cpu", spec=object())
    # quantized pages exist only in the MLA layout, which this config
    # does not have
    with pytest.raises(ValueError, match="MLA"):
        Engine(st, cfg, device="cpu", page_quant="int8")
    # MoE configs are taken (tests/test_torch_moe.py holds them to JAX):
    # the engine's temperature-0 tokens equal generate's
    mcfg = GPTConfig(**{**CFG_KW, "num_experts": 2})
    mst = random_state(mcfg, seed=3, device="cpu", std=0.2)
    meng = Engine(mst, mcfg, device="cpu")
    req = meng.add_request([5, 17, 2, 9, 33], 4)
    meng.run()
    assert list(req.out_tokens) == generate(
        mst, mcfg, [[5, 17, 2, 9, 33]], 4, device="cpu")[0, 5:].tolist()


def test_adopt_request_continues_as_generate_and_as_jax():
    """A request adopted mid-flight (prompt plus tokens generated
    elsewhere, no pages) re-prefills and continues exactly as an
    uninterrupted run, as the JAX engine's adoption does; its checks
    refuse what could never run."""
    state = _build_state(JaxGPTConfig(**CFG_KW), seed=11)
    cfg = GPTConfig(**CFG_KW)
    pst = state_from_numpy(state, cfg, device="cpu")
    prompt = [5, 17, 2, 9, 33, 12]
    full = generate(pst, cfg, [prompt], 10, device="cpu")[0, 6:].tolist()
    kw = dict(num_pages=16, page_size=8, max_batch=2, debug=True)
    eng = Engine(pst, cfg, device="cpu", **kw)
    req = eng.adopt_request(prompt, full[:4], 10)
    assert req.out_tokens == full[:4] and req.pos == 0
    eng.run()
    assert req.out_tokens == full
    jeng = JaxEngine(state, JaxGPTConfig(**CFG_KW), use_kernel=False, **kw)
    jreq = jeng.adopt_request(prompt, full[:4], 10)
    jeng.run()
    assert jreq.out_tokens == req.out_tokens
    with pytest.raises(ValueError, match="already finished"):
        eng.adopt_request(prompt, full, 10)
    with pytest.raises(ValueError, match="pages cover"):
        eng.adopt_request(prompt, full[:2], 10, pages=[], pos=4)
    with pytest.raises(ValueError, match="past the accumulated"):
        eng.adopt_request(prompt, full[:2], 10, pos=9)


def test_reset_metrics_keeps_the_compiled_step(tiny):
    cfg, st = tiny
    eng = Engine(st, cfg, num_pages=16, page_size=8, max_batch=2,
                 device="cpu", latency_buckets=[0.5, 2.0])
    eng.add_request([1, 2, 3], 3)
    eng.run()
    eng.reset_metrics()
    m = eng.metrics_summary()
    assert m["tokens_generated"] == m["step_calls"] == 0
    assert eng.steps == eng.executable_calls == 0
    assert m["ttft"]["count"] == 0 and list(m["ttft_buckets"]) == \
        ["0.5", "2.0", "+Inf"]
    assert m["compile_count"] == 1
    assert m["kv_bytes_per_token"] == eng.pool.kv_bytes_per_token
    eng.add_request([4, 5], 2)
    eng.run()
    assert eng.metrics_summary()["tokens_generated"] == 2


def test_engine_without_cpu_device_raises_here(tiny):
    cfg, st = tiny
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(st, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate(st, cfg, [[1, 2]], 2)


# ---------------------------------------------------------------------------
# import rules
# ---------------------------------------------------------------------------

_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|hetu_tpu)\b"
                        r"(?!_torch)", re.M)


def test_port_sources_import_no_jax_and_no_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "compare_compiled_step.py")]
    for root, _, names in os.walk(os.path.join(REPO, "hetu_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            hits = _FORBIDDEN.findall(f.read())
        assert not hits, f"{path} imports {hits}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, hetu_tpu_torch.serving, hetu_tpu_torch.models."
            "convert, hetu_tpu_torch.graph, hetu_tpu_torch.optim, "
            "hetu_tpu_torch.ops.flash_attention, hetu_tpu_torch.models.gpt"
            "\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'hetu_tpu')]\n"
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    assert out == "[]"
