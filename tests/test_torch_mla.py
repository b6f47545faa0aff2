"""MLA latent serving in the port against the JAX package, on the CPU.

The same numpy inputs and weights, drawn from a seed, go through the JAX
functions and their counterparts in the port:

- ``quantize_rows``: codes and absmax EQUAL to JAX's (pages carry them);
  ``dequantize_rows`` within 1e-7;
- the latent plain versions against JAX's references and the Pallas
  kernel in interpret mode: fp32, rtol = atol = 2e-5 on real tokens (they
  differ only in the order of fp32 sums);
- ``mla_state_from``: the same arrays as JAX's within 1e-6 (one SVD per
  layer on both sides), and the schema;
- dense ``generate`` on tiny learned and rotary MLA models: last-position
  logits within 1e-4, greedy tokens equal;
- the engine on mixed traffic: greedy tokens equal to the JAX engine's
  and to the port's own ``generate``; quantized pages deterministic;
- the pool's latent layouts, tags and byte counts;
- the latent kernel's tensor-core arithmetic, emulated: split TF32 terms
  within the card's 1e-4 (1 + |want|) gate, one-term TF32 over it.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hetu_tpu as ht
from hetu_tpu.models import GPTConfig as JaxGPTConfig, GPTLMHeadModel
from hetu_tpu.models.gpt import mla_state_from as jax_mla_state_from
from hetu_tpu.ops import quantization as jax_quant
from hetu_tpu.ops.ragged_paged_attention import (
    latent_paged_attention_reference as jax_latent_decode,
    latent_ragged_paged_attention_pallas as jax_latent_pallas,
    latent_ragged_paged_attention_reference as jax_latent_reference)
from hetu_tpu.serving import Engine as JaxEngine
from hetu_tpu_torch.models import (GPTConfig, GPTLMHeadModel as PortModel,
                                   mla_config, mla_state_from)
from hetu_tpu_torch.models import generate as port_gen
from hetu_tpu_torch.models.convert import (random_state, state_from_numpy,
                                           state_shapes)
from hetu_tpu_torch.ops import quantization as port_quant
from hetu_tpu_torch.ops.ragged_paged_attention import (
    latent_paged_attention_reference, latent_ragged_paged_attention,
    latent_ragged_paged_attention_cuda,
    latent_ragged_paged_attention_reference)
from hetu_tpu_torch.serving import Engine, PagedKVPool
from hetu_tpu_torch.serving.decode import build_unified_step_fn
from hetu_tpu_torch.serving.kv_pool import page_shape_bytes

jax_gen = importlib.import_module("hetu_tpu.models.generate")

CFG_KW = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=64, sp=False, dropout=0.0)
LEARNED = dict(position="learned", norm="layernorm", activation="gelu",
               **CFG_KW)
ROTARY = dict(position="rotary", norm="rmsnorm", activation="swiglu",
              **CFG_KW)
TOL = dict(rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# (a) row quantization: codes carried by pages must be bit-equal
# ---------------------------------------------------------------------------

def _quant_rows():
    """Rows of mixed scale, a zero row, +-absmax, and exact ties between
    two codebook entries (the midpoints of neighbouring nf4/fp4 codes and
    int8 half-steps)."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, 16).astype(np.float32) * np.asarray(
        [0.1, 1.0, 10.0, 0.01, 3.0, 0.0, 1.0, 1.0], np.float32)[:, None]
    nf4, fp4 = jax_quant.NF4_CODE, jax_quant.FP4_CODE
    mids = ((nf4[:-1] + nf4[1:]) / 2).astype(np.float32)       # 15 ties
    x[6] = np.concatenate([[1.0], mids])                       # absmax 1
    fmid = np.sort(np.unique(fp4))
    fmid = ((fmid[:-1] + fmid[1:]) / 2).astype(np.float32)
    x[7] = np.resize(np.concatenate([[-1.0, 1.0, 0.0, -0.0], fmid,
                                     [0.5 / 127, 1.5 / 127, 2.5 / 127]]),
                     16)
    return x


@pytest.mark.parametrize("quant", ["int8", "nf4", "fp4"])
def test_quantize_rows_codes_equal_jax(quant):
    x = _quant_rows()
    jc, ja = jax_quant.quantize_rows(jnp.asarray(x), quant)
    pc, pa = port_quant.quantize_rows(torch.from_numpy(x), quant)
    assert pc.dtype == (torch.int8 if quant == "int8" else torch.uint8)
    assert np.array_equal(pc.numpy(), np.asarray(jc))
    assert np.array_equal(pa.numpy(), np.asarray(ja))
    jd = np.asarray(jax_quant.dequantize_rows(jc, ja, quant, 16))
    pd = port_quant.dequantize_rows(pc, pa, quant, 16).numpy()
    np.testing.assert_allclose(pd, jd, rtol=0, atol=1e-7)
    assert not pd[5].any()                                # zero row exact


def test_quantize_rows_codebooks_and_refusals():
    assert np.array_equal(port_quant.NF4_CODE, jax_quant.NF4_CODE)
    # array_equal treats 0.0 and -0.0 as equal: compare the bits
    assert port_quant.FP4_CODE.tobytes() == jax_quant.FP4_CODE.tobytes()
    with pytest.raises(ValueError, match="even width"):
        port_quant.quantize_rows(torch.zeros(2, 5), "nf4")
    with pytest.raises(ValueError, match="unknown row quant"):
        port_quant.quantize_rows(torch.zeros(2, 4), "int4")
    with pytest.raises(ValueError, match="unknown row quant"):
        port_quant.dequantize_rows(torch.zeros(2, 4), torch.ones(2, 1),
                                   "int4", 4)


# ---------------------------------------------------------------------------
# (b), (c) the latent plain versions
# ---------------------------------------------------------------------------

def _latent_batch(quant, d_r):
    """The batch of tests/test_mla_serving.py's kernel test: mixed chunks,
    a decode row, a padding row, partial last pages, shuffled tables."""
    rng = np.random.RandomState(0)
    nh, d_c, num_pages, ps, maxp, max_q = 4, 16, 12, 8, 3, 8
    q_lens, ctx_lens = [1, 5, 0, 6], [13, 10, 0, 6]
    s = len(q_lens)
    cu = np.zeros(s + 1, np.int32)
    cu[1:] = np.cumsum(q_lens)
    t = int(cu[-1])
    q = rng.randn(t, nh, d_c + d_r).astype(np.float32)
    lat = rng.randn(num_pages, ps, 1, d_c).astype(np.float32)
    scale_pages = None
    if quant:
        codes, absmax = jax_quant.quantize_rows(jnp.asarray(lat), quant)
        c_pages, scale_pages = np.array(codes), np.array(absmax)
    else:
        c_pages = lat
    r_pages = rng.randn(num_pages, ps, 1, d_r).astype(np.float32) \
        if d_r else None
    perm = rng.permutation(np.arange(1, num_pages))
    pt = np.zeros((s, maxp), np.int32)
    k = 0
    for i in range(s):
        need = -(-ctx_lens[i] // ps)
        pt[i, :need] = perm[k:k + need]
        k += need
    meta = (np.asarray(q_lens, np.int32), cu, pt,
            np.asarray(ctx_lens, np.int32))
    kw = dict(max_q=max_q, softmax_scale=(d_c + d_r) ** -0.5, quant=quant,
              latent_dim=d_c)
    real = np.zeros(t, bool)
    for i in range(s):
        real[cu[i]:cu[i] + q_lens[i]] = True
    return q, c_pages, r_pages, scale_pages, meta, kw, real


def _both(fn_jax, fn_port, q, c_pages, r_pages, scale_pages, meta, kw):
    def j(a):
        return None if a is None else jnp.asarray(a)

    def p(a):
        return None if a is None else torch.from_numpy(a)
    want = fn_jax(j(q), j(c_pages), j(r_pages), *map(j, meta),
                  scale_pages=j(scale_pages), **kw)
    got = fn_port(p(q), p(c_pages), p(r_pages), *map(p, meta),
                  scale_pages=p(scale_pages), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("quant,d_r", [(None, 4), (None, 0), ("int8", 0),
                                       ("nf4", 0)])
def test_latent_plain_version_matches_jax_reference_and_pallas(quant, d_r):
    q, c_pages, r_pages, scale_pages, meta, kw, real = _latent_batch(
        quant, d_r)
    got, ref = _both(jax_latent_reference,
                     latent_ragged_paged_attention_reference, q, c_pages,
                     r_pages, scale_pages, meta, kw)
    _, pal = _both(lambda *a, **k: jax_latent_pallas(*a, interpret=True,
                                                     **k),
                   latent_ragged_paged_attention, q, c_pages, r_pages,
                   scale_pages, meta, kw)
    assert got.shape == (q.shape[0], 4, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got[real], ref[real], **TOL)
    np.testing.assert_allclose(got[real], pal[real], **TOL)
    assert not got[~real].any(), "padding tokens must stay 0"


@pytest.mark.parametrize("quant,d_r", [(None, 4), (None, 0), ("int8", 0),
                                       ("nf4", 0)])
def test_latent_decode_version_matches_jax(quant, d_r):
    """One token per request against ``seq_lens`` (``-inf`` mask)."""
    q, c_pages, r_pages, scale_pages, meta, kw, _ = _latent_batch(quant, d_r)
    seq_lens = np.asarray([13, 10, 1, 6], np.int32)
    kw = {k: v for k, v in kw.items() if k != "max_q"}
    got, want = _both(
        lambda q_, c_, r_, pt_, sl_, **k: jax_latent_decode(
            q_, c_, r_, pt_, sl_, **k),
        lambda q_, c_, r_, pt_, sl_, **k: latent_paged_attention_reference(
            q_, c_, r_, pt_, sl_, **k),
        q[:4], c_pages, r_pages, scale_pages, (meta[2], seq_lens), kw)
    np.testing.assert_allclose(got, want, **TOL)


def test_latent_shape_checks_and_cpu_refusal():
    q, c_pages, r_pages, _, meta, kw, _ = _latent_batch(None, 4)
    t = [torch.from_numpy(a) for a in (q, c_pages, r_pages, *meta)]
    with pytest.raises(ValueError, match="ONE shared stream"):
        latent_ragged_paged_attention_reference(
            t[0], t[1].expand(-1, -1, 2, -1), *t[2:], **kw)
    with pytest.raises(ValueError, match="absorbed q width"):
        latent_ragged_paged_attention_reference(t[0][..., :18], *t[1:], **kw)
    with pytest.raises(ValueError, match="latent_dim/2"):
        latent_ragged_paged_attention_reference(
            t[0], t[1], None, *t[3:], **{**kw, "quant": "nf4"})
    with pytest.raises(ValueError, match="need scale_pages"):
        latent_ragged_paged_attention_reference(
            t[0][..., :16], t[1].to(torch.int8), None, *t[3:],
            **{**kw, "quant": "int8"})
    # the kernel's wrapper never runs the plain version instead
    with pytest.raises(ValueError, match="CUDA device"):
        latent_ragged_paged_attention_cuda(*t, **kw)


# ---------------------------------------------------------------------------
# (d) the converter
# ---------------------------------------------------------------------------

def _build_state(cfg, seed=3):
    ht.set_seed(seed)
    with ht.graph("eager", create_new=True):
        model = GPTLMHeadModel(cfg)
        model.logits(np.zeros((1, 4), np.int32))
        state = {k: np.asarray(v) for k, v in model.state_dict().items()}
    return state


@pytest.fixture(scope="module")
def mla():
    """Learned-position base checkpoint and its latent conversion by the
    JAX package (d_c = 16, a 4x page compression)."""
    state = _build_state(JaxGPTConfig(**LEARNED), seed=3)
    lstate, lcfg = jax_mla_state_from(state, JaxGPTConfig(**LEARNED),
                                      kv_latent_dim=16)
    return state, lstate, lcfg


@pytest.fixture(scope="module")
def mla_rot():
    """Rotary base and its conversion with a decoupled rope stream
    (d_r = 4)."""
    state = _build_state(JaxGPTConfig(**ROTARY), seed=7)
    rstate, rcfg = jax_mla_state_from(state, JaxGPTConfig(**ROTARY),
                                      kv_latent_dim=16, kv_rope_dim=4)
    return state, rstate, rcfg


def _port_cfg(jcfg):
    import dataclasses
    return GPTConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("which", ["learned", "rotary"])
def test_mla_state_from_equals_jax(which, mla, mla_rot):
    state, jstate, jcfg = mla if which == "learned" else mla_rot
    base = GPTConfig(**(LEARNED if which == "learned" else ROTARY))
    pstate, pcfg = mla_state_from(state, base, kv_latent_dim=16,
                                  kv_rope_dim=jcfg.kv_rope_dim)
    assert pcfg == _port_cfg(jcfg) and pcfg.is_mla and not base.is_mla
    assert pcfg.rope_dim == (0 if which == "learned" else 4)
    assert set(pstate) == set(jstate)
    for k in jstate:
        np.testing.assert_allclose(pstate[k], np.asarray(jstate[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    # the same from port tensors, as ``random_state`` returns them
    tstate = state_from_numpy(state, base, device="cpu")
    again, _ = mla_state_from(tstate, base, kv_latent_dim=16,
                              kv_rope_dim=jcfg.kv_rope_dim)
    for k in pstate:
        assert np.array_equal(again[k], pstate[k]), k


def test_config_validation_and_converter_schema(mla):
    _, lstate, _ = mla
    cfg = GPTConfig(**LEARNED)
    with pytest.raises(ValueError):
        GPTConfig(kv_rope_dim=8, **CFG_KW)          # rope dim needs MLA
    assert mla_config(cfg, 16).kv_latent_dim == 16
    rcfg = mla_config(GPTConfig(**ROTARY), 16, kv_rope_dim=4)
    assert rcfg.rope_dim == 4
    # weight-absorbed schema replaces the fused qkv per layer, and
    # ``state_from_numpy`` and ``random_state`` keep its names and shapes
    carried = state_from_numpy(lstate, mla_config(cfg, 16), device="cpu")
    assert not any(".attn.qkv." in k for k in carried)
    drawn = random_state(rcfg, seed=0, device="cpu", dtype=torch.float32)
    shapes = state_shapes(rcfg)
    for i in range(cfg.num_layers):
        assert tuple(carried[f"h{i}.attn.kv_a.weight"].shape) == (16, 32)
        assert tuple(carried[f"h{i}.attn.q.bias"].shape) == (32,)
        for part in ("k_up", "v_up"):
            assert tuple(carried[f"h{i}.attn.{part}.weight"].shape) == \
                (4, 8, 16)
            assert shapes[f"h{i}.attn.{part}.weight"] == (4, 8, 16)
        assert tuple(drawn[f"h{i}.attn.q.weight"].shape) == (4 * 12, 32)
        assert tuple(drawn[f"h{i}.attn.kv_a.weight"].shape) == (20, 32)
    assert not any(".attn.qkv." in k for k in drawn)
    # MLA is a serving layout: the training model refuses it as JAX does
    with pytest.raises(ValueError, match="mla_state_from"):
        PortModel(mla_config(cfg, 16))


# ---------------------------------------------------------------------------
# (e) dense generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["learned", "rotary"])
def test_mla_generate_matches_jax(which, mla, mla_rot):
    _, jstate, jcfg = mla if which == "learned" else mla_rot
    pcfg = _port_cfg(jcfg)
    pstate = state_from_numpy(jstate, pcfg, device="cpu")
    prompts = np.asarray([[5, 17, 2, 9, 33, 12], [1, 1, 4, 44, 8, 3]],
                         np.int32)
    want = np.asarray(jax_gen.generate(jstate, jcfg, prompts, 8))
    got = port_gen.generate(pstate, pcfg, prompts, 8, device="cpu")
    assert got.tolist() == want.tolist()
    # last-position logits of one prefill pass, within 1e-4 absolute
    ids = np.asarray([[5, 17, 2, 9, 33, 12, 60]], np.int32)
    max_len = 16
    shapes = ((1, max_len, 1, jcfg.kv_latent_dim),
              (1, max_len, 1, jcfg.rope_dim))
    jcos, jsin = (jax_gen._rotary_tables(jcfg, max_len)
                  if jcfg.position == "rotary" else (None, None))
    jl, _ = jax_gen.decode_step(
        jcfg, jax_gen._Params(jstate, jcfg), jnp.asarray(ids),
        [tuple(jnp.zeros(s) for s in shapes)
         for _ in range(jcfg.num_layers)], 0, jcos, jsin)
    pcos, psin = (port_gen._rotary_tables(pcfg, max_len)
                  if pcfg.position == "rotary" else (None, None))
    if which == "rotary":
        assert tuple(pcos.shape) == (max_len, 4)     # rope_dim, not head_dim
    pl = port_gen.decode_step(
        pcfg, port_gen._Params(pstate, pcfg), torch.from_numpy(ids),
        [tuple(torch.zeros(s) for s in shapes)
         for _ in range(pcfg.num_layers)], 0, pcos, psin)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# (f), (g) the engine
# ---------------------------------------------------------------------------

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


HEADER = [5, 17, 2, 9, 33, 12, 8, 1]                  # one whole page
TRAFFIC = [(0, HEADER + [3, 2, 1, 9, 6, 5, 4, 7, 7], 6),     # > chunk
           (0, [1, 1, 4, 44], 8),
           (2, [3, 2, 1, 9, 6, 5, 4], 8),              # late arrival
           (14, HEADER + [40, 41], 5)]                 # prefix hit
ENGINE_KW = dict(num_pages=6, page_size=8, max_batch=3, chunk_size=4,
                 debug=True)


@pytest.mark.parametrize("which", ["learned", "rotary"])
def test_mla_engine_matches_jax_engine_and_generate(which, mla, mla_rot):
    """Chunked prompt, late arrival, preemption under a small pool and a
    prefix-cache hit on latent pages: greedy tokens equal the JAX
    engine's, the port's ``generate`` and equal scheduling counters."""
    _, jstate, jcfg = mla if which == "learned" else mla_rot
    pcfg = _port_cfg(jcfg)
    pstate = state_from_numpy(jstate, pcfg, device="cpu")
    jeng, jout = _drive(lambda tf: JaxEngine(
        jstate, jcfg, time_fn=tf, use_kernel=False, **ENGINE_KW), TRAFFIC)
    peng, pout = _drive(lambda tf: Engine(
        pstate, pcfg, time_fn=tf, device="cpu", **ENGINE_KW), TRAFFIC)
    assert pout == jout
    solo = [port_gen.generate(pstate, pcfg, [p], n, device="cpu")
            [0, len(p):].tolist() for _, p, n in TRAFFIC]
    assert pout == solo
    for name in ("preemptions", "prefix_cache_hits", "prefill_tokens",
                 "tokens_generated", "step_calls"):
        assert peng.counters[name].value == jeng.counters[name].value, name
    assert peng.counters["preemptions"].value >= 1
    assert peng.counters["prefix_cache_hits"].value >= 1
    assert peng.pool.is_latent and peng.pool.used_pages == 0
    assert peng.pool.layout_tag == jeng.pool.layout_tag
    d_r = 0 if which == "learned" else 4
    assert peng.pool.kv_bytes_per_token == jeng.pool.kv_bytes_per_token \
        == (16 + d_r) * 4 * pcfg.num_layers
    assert peng.metrics_summary()["kv_bytes_per_token"] == \
        peng.pool.kv_bytes_per_token
    assert tuple(peng.pool.v_pages[0].shape)[-1] == d_r


@pytest.mark.parametrize("quant", ["int8", "nf4"])
def test_quantized_latent_engine_deterministic_and_equals_jax(quant, mla):
    """Two fresh engines emit identical tokens, every request gets its
    full count, and the tokens equal the JAX engine's on the trace of
    tests/test_mla_serving.py (both write the same codes, so the greedy
    margins of the tiny model are those of the JAX run)."""
    _, jstate, jcfg = mla
    pcfg = _port_cfg(jcfg)
    pstate = state_from_numpy(jstate, pcfg, device="cpu")
    rng = np.random.RandomState(5)
    prompts = [[int(t) for t in rng.randint(1, 90, size=n)]
               for n in (14, 6)]
    traffic = [(0, p, 8) for p in prompts]
    kw = dict(num_pages=16, page_size=8, max_batch=2, chunk_size=8,
              debug=True, page_quant=quant)
    runs = [_drive(lambda tf: Engine(pstate, pcfg, time_fn=tf, device="cpu",
                                     **kw), traffic) for _ in range(2)]
    assert runs[0][1] == runs[1][1]
    assert all(len(t) == 8 for t in runs[0][1])
    eng = runs[0][0]
    assert eng.pool.quant == quant
    assert eng.pool.k_pages[0].dtype == (torch.int8 if quant == "int8"
                                         else torch.uint8)
    _, jout = _drive(lambda tf: JaxEngine(jstate, jcfg, time_fn=tf,
                                          use_kernel=False, **kw), traffic)
    assert runs[0][1] == jout


def test_page_quant_refusals(mla, mla_rot):
    state, jstate, jcfg = mla
    with pytest.raises(ValueError, match="MLA"):
        Engine(state_from_numpy(state, GPTConfig(**LEARNED), device="cpu"),
               GPTConfig(**LEARNED), num_pages=8, page_size=8, max_batch=2,
               page_quant="int8", device="cpu")
    rcfg = _port_cfg(mla_rot[2])
    with pytest.raises(ValueError, match="rope_dim == 0"):
        build_unified_step_fn(rcfg, 2, 8, 1, 4, 8, page_quant="int8")
    with pytest.raises(ValueError, match="rope_dim == 0"):
        build_unified_step_fn(GPTConfig(**LEARNED), 2, 8, 1, 4, 8,
                              page_quant="nf4")
    pcfg = _port_cfg(jcfg)
    pstate = state_from_numpy(jstate, pcfg, device="cpu")
    with pytest.raises(NotImplementedError):
        Engine(pstate, pcfg, device="cpu", mesh=object())
    # the host KV tier is served in the latent layout too (its round
    # trips are held in tests/test_torch_slo.py)
    assert Engine(pstate, pcfg, device="cpu",
                  host_tier=True).host_tier is not None
    # speculative decoding is served (tests/test_torch_spec_decode.py);
    # what is not a SpecConfig is refused
    with pytest.raises(TypeError, match="SpecConfig"):
        Engine(pstate, pcfg, device="cpu", spec=object())


# ---------------------------------------------------------------------------
# (h) pool layouts
# ---------------------------------------------------------------------------

def test_pool_layouts_tags_and_bytes():
    kw = dict(num_layers=2, num_pages=6, page_size=4, kv_heads=2,
              head_dim=8, device="cpu")
    full = PagedKVPool(**kw)
    lat = PagedKVPool(latent_dim=16, **kw)
    rope = PagedKVPool(latent_dim=16, rope_dim=4, **kw)
    q8 = PagedKVPool(latent_dim=16, quant="int8", **kw)
    q4 = PagedKVPool(latent_dim=16, quant="nf4", **kw)
    pools = (full, lat, rope, q8, q4)
    assert [p.layout_tag for p in pools] == [
        (0, 2, 8, 0, 4), (1, 16, 0, 0, 4), (1, 16, 4, 0, 4),
        (1, 16, 0, 1, 4), (1, 16, 0, 2, 4)]            # the JAX pool's tags
    assert [p.is_latent for p in pools] == [False, True, True, True, True]
    for p in pools:
        ks, vs = p.page_array_shapes()
        want = sum(page_shape_bytes(s, a.dtype)
                   for s, a in zip(ks + vs, p.k_pages + p.v_pages))
        assert p.page_bytes == want
        assert p.kv_bytes_per_token * p.page_size == p.page_bytes
    L = kw["num_layers"]
    assert full.kv_bytes_per_token == 2 * 2 * 8 * 4 * L   # 2 streams
    assert lat.kv_bytes_per_token == 16 * 4 * L
    assert rope.kv_bytes_per_token == (16 + 4) * 4 * L
    assert q8.kv_bytes_per_token == (16 + 4) * L          # codes + scale
    assert q4.kv_bytes_per_token == (8 + 4) * L
    assert q8.k_pages[0].dtype == torch.int8
    assert q4.k_pages[0].dtype == torch.uint8
    assert q4.k_pages[0].shape[-1] == 8                # packed pairs
    assert q8.v_pages[0].shape[-1] == 1                # absmax sidecar
    assert q8.v_pages[0].dtype == torch.float32
    assert PagedKVPool(latent_dim=16, dtype=torch.bfloat16,
                       **kw).layout_tag == (1, 16, 0, 0, 2)
    # the quant gate: latent-only, rope-free, even width, known kinds
    with pytest.raises(ValueError, match="latent"):
        PagedKVPool(quant="int8", **kw)                # no latent
    with pytest.raises(ValueError, match="rope_dim == 0"):
        PagedKVPool(latent_dim=16, rope_dim=4, quant="int8", **kw)
    with pytest.raises(ValueError, match="even latent_dim"):
        PagedKVPool(latent_dim=15, quant="nf4", **kw)  # odd width
    with pytest.raises(ValueError, match="int8|nf4"):
        PagedKVPool(latent_dim=16, quant="fp4", **kw)


# ---------------------------------------------------------------------------
# the latent kernel's tensor-core arithmetic (csrc/latent_ragged_paged_
# attention.cu): split TF32 terms against the card's fp32 gate
# ---------------------------------------------------------------------------

def _tf32(x):
    """x rounded to TF32 as the kernel rounds its operands: to nearest on
    10 mantissa bits, ties away from zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm_terms(a, b, terms, b_exact):
    """a @ b from TF32 parts of fp32 ``a``: ``terms`` 2 (a_lo.b + a_hi.b,
    for a ``b`` exact in TF32), 3 (lo.hi + hi.lo + hi.hi) or 1 (hi.hi)."""
    ah, al = _split(a)
    if terms == 1:
        return ah @ (b if b_exact else _tf32(b))
    if b_exact:
        return al @ b + ah @ b
    bh, bl = _split(b)
    return al @ bh + ah @ bl + ah @ bh


# (name, nh, d_c, d_r, query tokens, context, softmax scale): phase 9's
# GPT-2 widths (a 64-token chunk at the end of a 900-token context) and a
# few rows of its Llama-3-8B MLA widths (d_c 512, d_r 64 for unquantized
# pages; quantized pools carry no rope stream)
LATENT_TF32_WIDTHS = [("gpt2_mla", 12, 256, 0, 64, 900, 64 ** -0.5),
                      ("llama3_8b_mla", 32, 512, 64, 4, 3000, 192 ** -0.5)]
# the kernel's terms by page kind: bf16 latents and int8 codes are exact in
# TF32, nf4 codebook values and fp32 latents are not
LATENT_TERMS = {"bf16": 2, "int8": 2, "nf4": 3, "fp32": 3}


def _latent_tf32_ratio(kind, width, terms, seed=0):
    """Largest |got - want| over the card's latent gate, 1e-4 (1 + |want|),
    for the kernel's arithmetic in ``terms`` TF32 terms: S = Q K^T on the
    bare page values (int8 codes, nf4 codebook entries) with each cached
    token's scale (scale / 127 for int8, the absmax for nf4) folded into
    its score column, the softmax in fp32, P times the folded scale by V;
    ``want`` is the softmax of the exactly dequantized keys in fp64."""
    _, nh, d_c, d_r, n, ctx, scale = width
    if kind in ("int8", "nf4"):
        d_r = 0
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(n * nh, d_c + d_r).astype(np.float32))
    lat = torch.from_numpy(rng.randn(ctx, d_c).astype(np.float32))
    cs = torch.ones(ctx)
    if kind in ("int8", "nf4"):
        codes, absmax = port_quant.quantize_rows(lat, kind)
        deq = port_quant.dequantize_rows(codes, absmax, kind, d_c)
        sc = torch.where(absmax > 0, absmax, torch.ones_like(absmax))[:, 0]
        if kind == "int8":
            kv, cs = codes.float(), sc / 127.0
        else:
            idx = torch.stack([(codes >> 4).long(), (codes & 0xF).long()],
                              -1).reshape(ctx, d_c)
            kv, cs = torch.from_numpy(port_quant.NF4_CODE)[idx], sc
    else:
        deq = lat.bfloat16().float() if kind == "bf16" else lat
        kv = deq
    keys, want_keys = kv, deq
    if d_r:
        rope = torch.from_numpy(rng.randn(ctx, d_r).astype(np.float32))
        rope = rope.bfloat16().float() if kind == "bf16" else rope
        keys = torch.cat([kv, rope], -1)
        want_keys = torch.cat([deq, rope], -1)
    qpos = (ctx - n + torch.arange(n)).repeat_interleave(nh)
    visible = torch.arange(ctx)[None] <= qpos[:, None]
    s = (q.double() @ want_keys.double().T * scale).masked_fill(
        ~visible, float("-inf"))
    want = (torch.softmax(s, -1) @ deq.double()).float()
    exact = LATENT_TERMS[kind] == 2
    s = _mm_terms(q, keys.T, terms, exact) * cs[None] * scale
    s = s.masked_fill(~visible, -0.7 * float(np.finfo(np.float32).max))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    got = _mm_terms(p * cs[None], kv, terms, exact) / p.sum(-1, keepdim=True)
    return float(((got - want).abs() / (1e-4 * (1 + want.abs()))).max())


@pytest.mark.parametrize("width", LATENT_TF32_WIDTHS,
                         ids=[w[0] for w in LATENT_TF32_WIDTHS])
@pytest.mark.parametrize("kind", sorted(LATENT_TERMS))
def test_latent_split_tf32_meets_the_gate_and_one_term_does_not(kind,
                                                               width):
    """The kernel's terms (two for bf16 and int8 pages, three for nf4 and
    fp32) stay far inside the card's 1e-4 (1 + |want|) gate; one-term
    TF32 (every product cut to hi.hi, the planted ``tf32_1term_latent``)
    is over it.  The TF32 parts are summed here by fp32 CPU products, not
    by the tensor cores' accumulator, whose bit loss over long chains
    shows only on the card (chip_smoke.py, phase 9)."""
    assert _latent_tf32_ratio(kind, width, LATENT_TERMS[kind]) <= 0.1
    assert _latent_tf32_ratio(kind, width, 1) > 1.0


# ---------------------------------------------------------------------------
# the wgmma route's arithmetic (bf16 pages): q and p in bf16 terms
# ---------------------------------------------------------------------------

def _bf16_terms(x, terms):
    """fp32 ``x`` as ``terms`` bf16 terms (hi = bf16(x), lo = bf16(x -
    hi)), each rounded to nearest, as the kernel's ``bf16_terms``."""
    hi = x.bfloat16().float()
    if terms == 1:
        return [hi]
    return [hi, (x - hi).bfloat16().float()]


def _stacked_product(a, b, terms, halves):
    """a @ b as the wgmma route forms it: the bf16 terms of ``a`` stacked
    as the rows of one product (each term's product exact, summed over
    the k-steps in fp32), the terms of a row added first (its hi row plus
    its lo row), then the ``halves`` (each consumer group's share of the
    reduction axis) added in fp32."""
    parts = torch.tensor_split(torch.arange(a.shape[1]), halves)
    total = None
    for idx in parts:
        t = None
        for term in _bf16_terms(a[:, idx], terms):
            p = (term.double() @ b[idx].double()).float()
            t = p if t is None else t + p
        total = t if total is None else total + t
    return total


def _latent_bf16_ratio(width, terms, seed=0):
    """Largest |got - want| over the card's latent gate, 1e-4 (1 + |want|),
    for bf16 pages in the wgmma route's arithmetic: S = Q K^T with q in
    ``terms`` bf16 terms (stacked rows; the two consumer groups' halves
    of the width added in fp32), the online softmax in base 2 in fp32,
    P V with p in ``terms`` bf16 terms; ``want`` is the fp64 softmax of
    the same bf16 keys."""
    _, nh, d_c, d_r, n, ctx, scale = width
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(n * nh, d_c + d_r).astype(np.float32))
    lat = torch.from_numpy(rng.randn(ctx, d_c).astype(np.float32))
    keys = lat.bfloat16().float()
    vals = keys
    if d_r:
        rope = torch.from_numpy(rng.randn(ctx, d_r).astype(np.float32))
        keys = torch.cat([keys, rope.bfloat16().float()], -1)
    qpos = (ctx - n + torch.arange(n)).repeat_interleave(nh)
    visible = torch.arange(ctx)[None] <= qpos[:, None]
    s = (q.double() @ keys.double().T * scale).masked_fill(
        ~visible, float("-inf"))
    want = (torch.softmax(s, -1) @ vals.double()).float()
    s2 = _stacked_product(q, keys.T, terms, 2) * (scale * 1.4426950408889634)
    s2 = s2.masked_fill(~visible, float("-inf"))
    p = torch.exp2(s2 - s2.amax(-1, keepdim=True))
    got = _stacked_product(p, vals, terms, 1) / p.sum(-1, keepdim=True)
    return float(((got - want).abs() / (1e-4 * (1 + want.abs()))).max())


# phase 9's bf16 widths (LATENT_TF32_WIDTHS) and a decode row over 4096
# positions at its Llama-3-8B MLA widths
LATENT_BF16_WIDTHS = LATENT_TF32_WIDTHS + [
    ("llama3_8b_mla_decode", 32, 512, 64, 1, 4096, 192 ** -0.5)]


@pytest.mark.parametrize("width", LATENT_BF16_WIDTHS,
                         ids=[w[0] for w in LATENT_BF16_WIDTHS])
def test_latent_bf16_terms_meet_the_gate_and_one_term_does_not(width):
    """The wgmma route's two bf16 terms of q and p (exact bf16 pages and
    rope keys) stay within 0.15 of the card's 1e-4 (1 + |want|) gate; one
    bf16 term (the planted ``bf16_1term_latent``) is over it.  Each
    term's product is exact here (fp64) and summed in fp32; the card's
    accumulator chains show only there (chip_smoke.py, phase 9)."""
    assert _latent_bf16_ratio(width, 2) <= 0.15
    assert _latent_bf16_ratio(width, 1) > 1.0


@pytest.mark.parametrize("quant,dtype,d_c,d_r,ps,rows,route", [
    (None, torch.bfloat16, 512, 64, 64, 9, "wgmma"),
    (None, torch.bfloat16, 256, 0, 16, 9, "wgmma"),
    (None, torch.bfloat16, 64, 0, 8, 1, "wgmma"),
    (None, torch.bfloat16, 448, 64, 64, 1024, "wgmma"),
    (None, torch.bfloat16, 576, 0, 64, 9, "mma.sync"),
    (None, torch.bfloat16, 96, 0, 64, 9, "mma.sync"),
    (None, torch.bfloat16, 128, 32, 64, 9, "mma.sync"),
    (None, torch.bfloat16, 16, 4, 64, 9, "mma.sync"),
    (None, torch.float32, 512, 64, 64, 9, "mma.sync"),
    ("int8", torch.int8, 256, 0, 64, 9, "mma.sync"),
    ("nf4", torch.uint8, 256, 0, 64, 9, "mma.sync"),
    (None, torch.bfloat16, 512, 64, 4, 9, "mma.sync"),
    (None, torch.bfloat16, 512, 64, 12, 9, "mma.sync"),
    (None, torch.bfloat16, 256, 0, 1, 9, "mma.sync"),
    (None, torch.bfloat16, 512, 64, 64, 1025, "mma.sync")])
def test_latent_route_by_kind_and_width(quant, dtype, d_c, d_r, ps, rows,
                                        route):
    """The latent kernel's route is a function of the page kind, the
    widths, the page size and the row count alone: bf16 pages at d_c a
    multiple of 64 up to 512 and d_r 0 or 64, pages of a multiple of 8
    positions and at most 1024 rows on wgmma, everything else on the split
    TF32 kernel."""
    from hetu_tpu_torch.ops.ragged_paged_attention import latent_route
    assert latent_route(quant, dtype, d_c, d_r, ps, rows) == route
