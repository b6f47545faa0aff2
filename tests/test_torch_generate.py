"""The port's dense ``generate`` against the JAX package's, in fp32.

Weights are built by the JAX model (as ``_build_state`` in
tests/test_serving_unified.py does) and carried across with
``state_from_numpy``.  Greedy tokens must be equal, and the
last-position logits within 1e-4 absolute.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hetu_tpu as ht
from hetu_tpu.models import GPTConfig as JaxGPTConfig, GPTLMHeadModel
from hetu_tpu_torch.core.device import resolve_device
from hetu_tpu_torch.core.dtype import torch_dtype
from hetu_tpu_torch.models import GPTConfig, llama3_8b_config
from hetu_tpu_torch.models import generate as port_gen
from hetu_tpu_torch.models.convert import (random_state, state_from_numpy,
                                           state_shapes)

# the package attribute ``generate`` is the function; take the module
jax_gen = importlib.import_module("hetu_tpu.models.generate")

# a tiny LLaMA-style config (GQA, rotary, RMSNorm, SwiGLU) and a tiny
# GPT-2-style one (learned positions, LayerNorm with bias, GELU)
CONFIGS = {
    "llama": dict(vocab_size=97, hidden_size=32, num_layers=2,
                  num_heads=4, num_kv_heads=2, max_seq_len=64, sp=False,
                  dropout=0.0, position="rotary", norm="rmsnorm",
                  activation="swiglu"),
    "gpt2": dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
                 max_seq_len=64, sp=False, dropout=0.0, position="learned",
                 norm="layernorm", activation="gelu"),
}


def _build_state(cfg, seed=3):
    ht.set_seed(seed)
    with ht.graph("eager", create_new=True):
        model = GPTLMHeadModel(cfg)
        model.logits(np.zeros((1, 4), np.int32))
        state = {k: np.asarray(v) for k, v in model.state_dict().items()}
    return state


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    kw = CONFIGS[request.param]
    state = _build_state(JaxGPTConfig(**kw), seed=5)
    return kw, state


def test_greedy_tokens_equal_jax(model):
    kw, state = model
    prompts = np.asarray([[5, 17, 2, 9, 33, 12], [1, 1, 4, 44, 8, 3]],
                         np.int32)
    want = np.asarray(jax_gen.generate(state, JaxGPTConfig(**kw), prompts,
                                       8))
    got = port_gen.generate(state_from_numpy(state, GPTConfig(**kw),
                                             device="cpu"),
                            GPTConfig(**kw), prompts, 8, device="cpu")
    assert got.tolist() == want.tolist()


def test_last_position_logits_within_1e4(model):
    kw, state = model
    ids = np.asarray([[5, 17, 2, 9, 33, 12, 60]], np.int32)
    jcfg, pcfg = JaxGPTConfig(**kw), GPTConfig(**kw)
    max_len = 16
    jp = jax_gen._Params(state, jcfg)
    cos, sin = (jax_gen._rotary_tables(jcfg, max_len)
                if jcfg.position == "rotary" else (None, None))
    shape = (1, max_len, jcfg.kv_heads, jcfg.head_dim)
    caches = [(jnp.zeros(shape), jnp.zeros(shape))
              for _ in range(jcfg.num_layers)]
    want, _ = jax_gen.decode_step(jcfg, jp, jnp.asarray(ids), caches, 0,
                                  cos, sin)
    pp = port_gen._Params(state_from_numpy(state, pcfg, device="cpu"),
                          pcfg)
    pcos, psin = (port_gen._rotary_tables(pcfg, max_len)
                  if pcfg.position == "rotary" else (None, None))
    pc = [(torch.zeros(shape), torch.zeros(shape))
          for _ in range(pcfg.num_layers)]
    got = port_gen.decode_step(pcfg, pp, torch.from_numpy(ids), pc, 0,
                               pcos, psin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_state_from_numpy_normalises_both_naming_conventions(model):
    kw, state = model
    cfg = GPTConfig(**kw)
    flat = {("h" + k[len("transformer.h."):]
             if k.startswith("transformer.h.") else
             k[len("transformer."):] if k.startswith("transformer.")
             else k): v for k, v in state.items()}
    a = state_from_numpy(state, cfg, device="cpu")
    b = state_from_numpy(flat, cfg, device="cpu", dtype="bfloat16")
    assert sorted(a) == sorted(b)
    assert all(b[k].dtype == torch.bfloat16 for k in b
               if b[k].is_floating_point())
    # the serving path's weights are all there, with their shapes
    for name, shape in state_shapes(cfg).items():
        assert tuple(a[name].shape) == shape, name


def test_random_state_is_seeded_and_shaped():
    cfg = llama3_8b_config(vocab_size=64, hidden_size=32, num_layers=2,
                           num_heads=4, num_kv_heads=2, ffn_hidden_size=48)
    a = random_state(cfg, seed=0, device="cpu")
    b = random_state(cfg, seed=0, device="cpu")
    c = random_state(cfg, seed=1, device="cpu")
    assert {k: tuple(v.shape) for k, v in a.items()} == state_shapes(cfg)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wte.weight"], c["wte.weight"])
    assert a["h0.attn.qkv.weight"].dtype == torch.bfloat16
    assert torch.all(a["ln_f.weight"] == 1)
    assert abs(a["lm_head.weight"].float().std().item() - 0.02) < 0.005


def test_llama3_8b_widths():
    cfg = llama3_8b_config()
    assert (cfg.vocab_size, cfg.hidden_size, cfg.num_layers,
            cfg.num_heads, cfg.kv_heads, cfg.head_dim, cfg.ffn_size) == \
        (128256, 4096, 32, 32, 8, 128, 14336)
    n = sum(int(np.prod(s)) for s in state_shapes(cfg).values())
    assert n == 8_030_261_248


def test_device_rules():
    assert resolve_device("cpu").type == "cpu"
    assert torch_dtype("bfloat16") is torch.bfloat16
    with pytest.raises(ValueError):
        torch_dtype("float8")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device()


def test_sampled_generate_is_seeded():
    kw = CONFIGS["llama"]
    cfg = GPTConfig(**kw)
    st = random_state(cfg, seed=2, device="cpu", dtype=torch.float32,
                      std=0.3)
    ids = [[5, 17, 2, 9]]
    a = port_gen.generate(st, cfg, ids, 10, temperature=0.9, top_k=5,
                          seed=11, device="cpu")
    b = port_gen.generate(st, cfg, ids, 10, temperature=0.9, top_k=5,
                          seed=11, device="cpu")
    assert a.tolist() == b.tolist()
    assert a.shape == (1, 14) and int(a.max()) < cfg.vocab_size
