"""The port's mixture of experts against the JAX package's, on the CPU.

Inputs and weights are numpy from a seed and go through both packages:
each gating function (routing equal, dispatch and combine within 2e-5),
``blocked_group_gemm`` against the dense all-experts mix and against
JAX's, ``MoELayer`` in both dispatch modes (forward, balance loss and
every gradient), a 2-layer MoE GPT's losses and updated weights over 3
Adam steps with two micro-batches, the MoE ``GPTPipelineModel``, greedy
``generate``, the serving engine (also with a speculative draft), and
expert parallelism (tests/test_torch_moe_ep.py).  fp32 throughout; the
tolerances are stated beside each comparison.
"""
import numpy as np
import pytest
import torch

import hetu_tpu as jht
from hetu_tpu import ops as jops
from hetu_tpu import optim as joptim
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPTLMHeadModel
from hetu_tpu.nn import moe as jmoe
import hetu_tpu_torch as ht
from hetu_tpu_torch import optim
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel, llama_config
from hetu_tpu_torch.models.convert import (load_module_state, load_state,
                                           module_state_numpy,
                                           state_from_numpy)
from hetu_tpu_torch.models.generate import generate
from hetu_tpu_torch.nn import moe as tmoe
from hetu_tpu_torch.ops import functional as tops
from hetu_tpu_torch.ops.moe_dispatch import (blocked_group_gemm,
                                             capacity_tokens,
                                             pick_block_size)


TOL = 2e-5


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# gating maths
# ---------------------------------------------------------------------------

GATES = {
    "topk1": (lambda m, lg: m.topk_gating_impl(lg, 1, 2.0), (16, 4)),
    "topk2": (lambda m, lg: m.topk_gating_impl(lg, 2, 1.0), (32, 8)),
    "ktop1": (lambda m, lg: m.ktop1_gating_impl(lg, 2, 2.0), (16, 8)),
    "sam": (lambda m, lg: m.sam_gating_impl(lg, 2, 4.0, 4), (16, 8)),
    "balance": (lambda m, lg: m.balance_gating_impl(lg, 1.25, n_iters=20),
                (64, 4)),
}


@pytest.mark.parametrize("name", sorted(GATES) + ["hash"])
def test_gating_matches_jax(name):
    """Routing equal (dispatch exactly), combine and the balance loss
    within 2e-5."""
    rng = np.random.RandomState(len(name))
    if name == "hash":
        ids = rng.randint(0, 1000, (24,)).astype(np.int32)
        want = jmoe.hash_gating_impl(ids % 4, 4, 1.0)
        got = tmoe.hash_gating_impl(torch.from_numpy(ids % 4), 4, 1.0)
    else:
        fn, shape = GATES[name]
        lg = rng.randn(*shape).astype(np.float32)
        if name == "balance":
            lg[:, 0] += 5.0           # every token prefers expert 0
        want = fn(jmoe, lg)
        got = fn(tmoe, torch.from_numpy(lg))
    (ja, jc, jd), (pa, pc, pd) = want, got
    assert pd.shape == _np(jd).shape
    np.testing.assert_array_equal(pd.numpy(), _np(jd))
    np.testing.assert_allclose(pc.numpy(), _np(jc), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(pa), float(_np(ja)), rtol=TOL,
                               atol=TOL)


def test_top_k_breaks_ties_toward_the_lower_index():
    """``lax.top_k``'s rule, which ``torch.topk`` does not promise."""
    import jax
    x = np.array([[0.25, 0.5, 0.5, 0.25, 0.5],
                  [1.0, 1.0, 1.0, 1.0, 1.0]], np.float32)
    jv, ji = jax.lax.top_k(x, 3)
    tv, ti = tmoe.top_k(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    assert ti.tolist() == [[1, 2, 4], [0, 1, 2]]


def test_capacity_and_block_helpers_match_jax():
    from hetu_tpu.models.generate import _moe_block_size as j_block
    from hetu_tpu.ops import moe_dispatch as jd
    for args in [(16, 4, 1, 2.0), (32, 8, 2, 1.25), (8192, 8, 2, 1.25)]:
        assert capacity_tokens(*args) == jd.capacity_tokens(*args)
    for n, e in [(4, 8), (512, 8), (16384, 8), (100, 4)]:
        assert pick_block_size(n, e) == jd.pick_block_size(n, e) == \
            j_block(n, e)


# ---------------------------------------------------------------------------
# the blocked group GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,E,k,block", [(48, 8, 2, None), (13, 4, 3, 8)])
def test_blocked_group_gemm_matches_the_dense_mix_and_jax(T, E, k, block):
    """Against the dense all-experts mix (tests/test_generate.py's
    oracle) and JAX's group GEMM, within 1e-5."""
    import jax
    import jax.numpy as jnp
    from hetu_tpu.ops.moe_dispatch import blocked_group_gemm as jgemm
    rng = np.random.RandomState(T)
    d, f = 16, 24
    x = rng.randn(T, d).astype(np.float32)
    gates = jax.nn.softmax(jnp.asarray(rng.randn(T, E), jnp.float32), -1)
    topv, topi = jax.lax.top_k(gates, k)
    w = [(rng.randn(*s) * 0.2).astype(np.float32)
         for s in ((E, d, f), (E, 1, f), (E, f, d), (E, 1, d))]
    want = jgemm(jnp.asarray(x), topi, topv, *map(jnp.asarray, w),
                 jax.nn.gelu, block=block)
    got = blocked_group_gemm(torch.from_numpy(x),
                             torch.from_numpy(np.array(topi)),
                             torch.from_numpy(np.array(topv)),
                             *map(torch.from_numpy, w),
                             tmoe.ACTIVATIONS["gelu"], block=block)
    h = _np(jax.nn.gelu(jnp.einsum("td,edf->tef", x, w[0]) + w[1][:, 0]))
    y = np.einsum("tef,efd->ted", h, w[2]) + w[3][:, 0]
    dense = np.zeros((T, d), np.float32)
    for j in range(k):
        sel = _np(topi)[:, j]
        dense += _np(topv)[:, j:j + 1] * y[np.arange(T), sel]
    assert got.dtype == torch.float32 and got.shape == (T, d)
    np.testing.assert_allclose(got.numpy(), dense, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

LAYER_CASES = [("topk", "capacity"), ("ktop1", "capacity"),
               ("sam", "capacity"), ("balance", "capacity"),
               ("hash", "capacity"), ("topk", "dropless")]


def _layer_state(gate_type, seed=7):
    """The layer's weights from a seed (non-zero expert biases, so that
    their paths are held too)."""
    rng = np.random.RandomState(seed)
    st = {"experts.w1": rng.randn(4, 16, 32) * 0.2,
          "experts.b1": rng.randn(4, 1, 32) * 0.05,
          "experts.w2": rng.randn(4, 32, 16) * 0.2,
          "experts.b2": rng.randn(4, 1, 16) * 0.05}
    if gate_type != "hash":
        st["gate.wg"] = rng.randn(4, 16) * 0.5
    return {k: v.astype(np.float32) for k, v in st.items()}


def _layer(pkg, gate_type, mode, X, ids, state):
    """``pkg``'s MoE layer on ``X``: out, l_aux, the loss, and the loss's
    gradient for every weight."""
    jax_side = pkg is jht
    mk = jmoe.make_moe_layer if jax_side else tmoe.make_moe_layer
    o = jops if jax_side else tops
    with pkg.graph("define_and_run", create_new=True,
                   **({} if jax_side else {"device": "cpu"})) as g:
        x = pkg.placeholder("float32", X.shape, name="x")
        tid = pkg.placeholder("int32", ids.shape, name="tid")
        moe = mk(16, 32, num_experts=4, gate_type=gate_type, k=2,
                 capacity_factor=2.0, num_groups=2, dispatch_mode=mode)
        out, l_aux = moe(x, token_ids=tid if gate_type == "hash" else None)
        loss = o.reduce_mean(out * out) + 0.01 * l_aux
        names = [n for n, _ in moe.named_parameters()]
        grads = g.make_gradients(loss, [p for _, p in
                                        moe.named_parameters()])
        if jax_side:
            moe.load_state_dict(state)
        else:
            load_module_state(moe, state)
        vals = g.run([out, l_aux, loss] + grads, feed_dict={x: X, tid: ids})
    return [_np(v) for v in vals[:3]], dict(zip(names, map(_np, vals[3:])))


@pytest.mark.parametrize("gate_type,mode", LAYER_CASES)
def test_moe_layer_matches_jax(gate_type, mode):
    """Forward (out within 2e-5, the balance loss and the loss within 2e-5
    relative) and the gradient of every weight within 1e-4 (the JAX and
    torch sums run in different orders)."""
    rng = np.random.RandomState(7)
    X = rng.randn(4, 8, 16).astype(np.float32)
    ids = rng.randint(0, 100, (4, 8)).astype(np.int32)
    state = _layer_state(gate_type)
    jvals, jgrads = _layer(jht, gate_type, mode, X, ids, state)
    pvals, pgrads = _layer(ht, gate_type, mode, X, ids, state)
    np.testing.assert_allclose(pvals[0], jvals[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(pvals[1], jvals[1], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pvals[2], jvals[2], rtol=TOL, atol=TOL)
    assert set(pgrads) == set(jgrads) == set(state)
    for k, v in jgrads.items():
        np.testing.assert_allclose(pgrads[k], v, rtol=0, atol=1e-4,
                                   err_msg=k)


def test_moe_layer_refusals_and_exports():
    """The JAX package's refusals, with its words; the ``nn`` exports."""
    with ht.graph("define_and_run", create_new=True, device="cpu"):
        ex = tmoe.Experts(4, 16, 32)
        with pytest.raises(ValueError, match="TopKGate"):
            tmoe.MoELayer(tmoe.HashGate(4), ex, dispatch_mode="dropless")
        with pytest.raises(ValueError, match="ep_axis sharding is not"):
            tmoe.MoELayer(tmoe.TopKGate(16, 4, k=2), ex, ep_axis="ep",
                          dispatch_mode="dropless")
        with pytest.raises(ValueError, match="dispatch_mode"):
            tmoe.make_moe_layer(16, 32, 4, dispatch_mode="bogus")
        with pytest.raises(ValueError, match="gate_type"):
            tmoe.make_moe_layer(16, 32, 4, gate_type="bogus")
    for name in ("MoELayer", "Experts", "TopKGate", "KTop1Gate", "HashGate",
                 "SAMGate", "BalanceGate", "make_moe_layer"):
        assert getattr(ht.nn, name) is getattr(tmoe, name)


def test_moe_under_context_parallelism_is_refused():
    """The check the model registers for each mesh: a cp axis of more
    than one rank raises, one of a single rank passes."""
    from hetu_tpu_torch.models.gpt import _no_moe_cp

    class _Mesh:
        def __init__(self, cp):
            self.cp = cp

        def axis_size(self, axis):
            return self.cp if axis == "cp" else 1

    check = _no_moe_cp(GPTConfig(**MOE_KW["gpt2"], cp_axis="cp"))
    check(_Mesh(1))
    with pytest.raises(NotImplementedError, match="context parallelism"):
        check(_Mesh(2))


def test_moe_meta_record_is_kept_on_the_graph():
    """``_record_analysis_meta`` appends to the graph's ``_moe_meta``
    list, as the JAX graph keeps it."""
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        x = ht.placeholder("float32", (2, 8, 16), name="x")
        moe = tmoe.make_moe_layer(16, 32, 4, k=2, capacity_factor=1.25)
        moe(x)
    (rec,) = g._moe_meta
    assert rec["tokens"] == 16 and rec["capacity"] == capacity_tokens(
        16, 4, 2, 1.25) and rec["dispatch_mode"] == "capacity"
    assert rec["name"] == "moe.experts.w1" and rec["dtype"] == "float32"


# ---------------------------------------------------------------------------
# the MoE GPT: training, pipeline, generate, serving
# ---------------------------------------------------------------------------

MOE_KW = {
    "llama": dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
                  num_kv_heads=2, max_seq_len=32, sp=False, dropout=0.0,
                  position="rotary", norm="rmsnorm", activation="swiglu",
                  num_experts=4, moe_top_k=2, moe_capacity_factor=1.25),
    "gpt2": dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
                 max_seq_len=32, sp=False, dropout=0.0, position="learned",
                 norm="layernorm", activation="gelu", num_experts=4,
                 moe_top_k=2, moe_capacity_factor=1.25, moe_every=2),
}
B, S = 4, 16


def _jax_state(kw, seed=5, bias_std=0.05):
    jht.set_seed(seed)
    with jht.graph("eager", create_new=True):
        model = JaxGPTLMHeadModel(JaxGPTConfig(**kw))
        model.logits(np.zeros((1, 4), np.int32))
        state = {k: np.asarray(v) for k, v in model.state_dict().items()}
    rng = np.random.RandomState(seed)
    # the experts' biases start at zero: make them matter
    return {k: v + rng.randn(*v.shape).astype(np.float32) * bias_std
            if k.endswith((".b1", ".b2")) else v for k, v in state.items()}


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 97, (B, S)).astype(np.int32),
            rng.randint(0, 97, (B, S)).astype(np.int32))


def _train(pkg, kw, state, x, y, steps=3, lr=1e-2, micro=2):
    jax_side = pkg is jht
    with pkg.graph("define_and_run", create_new=True,
                   **({} if jax_side else {"device": "cpu"})) as g:
        ids = pkg.placeholder("int32", (B, S), name="ids")
        labels = pkg.placeholder("int32", (B, S), name="labels")
        model = (JaxGPTLMHeadModel(JaxGPTConfig(**kw)) if jax_side
                 else GPTLMHeadModel(GPTConfig(**kw)))
        loss = model(ids, labels)
        train_op = (joptim if jax_side else optim).AdamOptimizer(
            lr=lr).minimize(loss)
        if jax_side:
            model.load_state_dict(state)
        else:
            load_state(model, state)
        losses = [float(_np(g.run(loss, [loss, train_op],
                                  {ids: x, labels: y},
                                  num_micro_batches=micro)[0]))
                  for _ in range(steps)]
    return losses, {k: _np(v) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", sorted(MOE_KW))
def test_moe_gpt_three_adam_steps_match_jax(name):
    """Losses within 2e-5, and each weight's update (the experts' and
    the gate's among them) within 1 % of the JAX update's largest element
    after 3 Adam steps of 2 micro-batches (phase 8's rule: Adam divides a
    gradient by its own scale, so rounding in a gradient near zero, the
    key bias's, moves its step); the loss falls."""
    kw = MOE_KW[name]
    state = _jax_state(kw)
    x, y = _batch()
    jl, jw = _train(jht, kw, state, x, y)
    pl, pw = _train(ht, kw, state, x, y)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=TOL)
    assert pl[-1] < pl[0]
    assert set(pw) == set(jw)
    assert any(".moe.experts.w1" in k for k in pw)
    for k, v in jw.items():
        assert _update_gap({k: pw[k]}, {k: v}, {k: state[k]}) <= 0.01, k


def test_moe_gpt_under_bf16_autocast_and_fused_ce_flag():
    """``fused_lm_ce`` is skipped with experts (as in JAX: the aux joins
    the loss), so the flag leaves the loss as it is; the experts run in
    the einsum's promoted dtype (fp32 here)."""
    kw = MOE_KW["llama"]
    state = _jax_state(kw)
    x, y = _batch(1)
    a, _ = _train(ht, kw, state, x, y, steps=1)
    b, _ = _train(ht, {**kw, "fused_lm_ce": True}, state, x, y, steps=1)
    assert a == b


def test_moe_generate_matches_jax_and_the_engine():
    """Greedy MoE ``generate`` equal to JAX's (tests/test_generate.py's
    config); the engine's temperature-0 tokens equal the port's solo
    ``generate`` (chunked prefill through the group GEMM, decode through
    the dense mix), with and without a speculative self-draft."""
    from hetu_tpu.models.generate import generate as jgenerate
    from hetu_tpu_torch.models import draft_state_from
    from hetu_tpu_torch.serving import Engine, SpecConfig
    kw = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=64, sp=False, dropout=0.0, position="learned",
              activation="gelu", num_experts=4, moe_top_k=2,
              moe_capacity_factor=8.0)
    state = _jax_state(kw)
    cfg = GPTConfig(**kw)
    prompt = np.array([[5, 17, 2, 9], [1, 1, 4, 88]], np.int32)
    want = _np(jgenerate(state, JaxGPTConfig(**kw), prompt, 6))
    pst = state_from_numpy(state, cfg, device="cpu")
    got = generate(pst, cfg, prompt, 6, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    prompts = [[5, 17, 2, 9, 33, 12, 40, 7, 3], [1, 1, 4, 88],
               list(range(20, 37))]
    solo = [generate(pst, cfg, [p], 8, device="cpu")[0, len(p):].tolist()
            for p in prompts]
    for spec in (None, SpecConfig(*draft_state_from(pst, cfg, 1), k=3)):
        eng = Engine(pst, cfg, device="cpu", num_pages=32, page_size=8,
                     max_batch=4, chunk_size=8, spec=spec)
        reqs = [eng.add_request(p, 8) for p in prompts]
        eng.run()
        assert [list(r.out_tokens) for r in reqs] == solo
        assert eng.compile_count == (1 if spec is None else 4)


PIPE_KW = dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=4,
               max_seq_len=16, sp=False, num_experts=4, moe_top_k=2,
               moe_every=1, moe_capacity_factor=2.0)


def _pipe_batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 64, (8, 16)).astype(np.int32)
    return ids, np.roll(ids, -1, 1)


def _jax_pipeline(steps=3, nmb=2):
    """The JAX pipeline model (one stage) from its seeded weights with
    the experts' biases made non-zero: (initial state, losses, final
    state)."""
    from hetu_tpu.models import llama_config as jllama
    from hetu_tpu.models.gpt_pipeline import GPTPipelineModel as JPipe
    jht.set_seed(555)
    mesh = jht.create_mesh({"pp": 1, "dp": 1, "tp": 1})
    I, L = _pipe_batch()
    with jht.graph("define_and_run", create_new=True, mesh=mesh) as g:
        ids = jht.placeholder("int32", (8, 16), name="ids")
        lbl = jht.placeholder("int32", (8, 16), name="lbl")
        m = JPipe(jllama(**PIPE_KW), num_stages=1)
        loss = m(ids, lbl, num_micro_batches=nmb)
        op = joptim.AdamOptimizer(lr=1e-2).minimize(loss)
        rng = np.random.RandomState(1)
        init = {k: _np(v) + (rng.randn(*v.shape).astype(np.float32) * 0.05
                             if k.startswith(("blk_moe_b1", "blk_moe_b2"))
                             else 0) for k, v in m.state_dict().items()}
        m.load_state_dict(init)
        losses = [float(_np(g.run(loss, [loss, op], {ids: I, lbl: L})[0]))
                  for _ in range(steps)]
        return init, losses, {k: _np(v) for k, v in m.state_dict().items()}


def test_moe_pipeline_matches_jax():
    """``GPTPipelineModel`` with MoE blocks (one stage, 2 micro-batches)
    against the JAX pipeline model (tests/test_pipeline.py's config):
    losses within 2e-5, each weight's update within 1 % after 3 Adam
    steps (as the GPT's); the stacked ``moe_*`` names carry to the plain
    model's and back."""
    from hetu_tpu_torch.models.convert import pipeline_state, plain_state
    from hetu_tpu_torch.models.gpt_pipeline import GPTPipelineModel
    init, jl, jw = _jax_pipeline()
    cfg = llama_config(**PIPE_KW)
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        ids = ht.placeholder("int32", (8, 16), name="ids")
        lbl = ht.placeholder("int32", (8, 16), name="lbl")
        m = GPTPipelineModel(cfg, num_stages=1)
        loss = m(ids, lbl, num_micro_batches=2)
        op = optim.AdamOptimizer(lr=1e-2).minimize(loss)
    load_module_state(m, init)
    I, L = _pipe_batch()
    pl = [float(g.run(loss, [loss, op], {ids: I, lbl: L})[0])
          for _ in range(3)]
    np.testing.assert_allclose(pl, jl, rtol=0, atol=TOL)
    assert pl[-1] < pl[0]
    pw = module_state_numpy(m)
    for k, v in jw.items():
        assert _update_gap({k: pw[k]}, {k: v}, {k: init[k]}) <= 0.01, k
    plain = plain_state(pw, cfg)
    assert "h3.mlp.moe.experts.w2" in plain
    back = pipeline_state(plain, cfg, 2)
    assert back["blk_moe_w1"].shape == (2, 2, 4, 32, cfg.ffn_size)


def test_moe_state_shapes_and_layout():
    """``random_state`` draws the MoE schema (zero expert biases) that
    ``generate`` reads, and ``param_layout`` splits the experts over ep."""
    from hetu_tpu_torch.models.convert import (param_layout, random_state,
                                               shard_state, gather_state)
    from hetu_tpu_torch.parallel import P
    cfg = GPTConfig(**MOE_KW["gpt2"], ep_axis="ep")
    st = random_state(cfg, device="cpu")
    assert st["h0.mlp.moe.experts.w1"].shape == (4, 32, cfg.ffn_size)
    assert "h1.mlp.up.weight" in st and "h0.mlp.up.weight" not in st
    assert float(st["h0.mlp.moe.experts.b2"].abs().sum()) == 0
    generate(st, cfg, [[1, 2, 3]], 2, device="cpu")
    lay = param_layout(cfg)
    assert lay["h0.mlp.moe.experts.w1"][0] == P("ep", None, None)
    assert lay["h0.mlp.moe.gate.wg"][0] == P()
    state = _jax_state(MOE_KW["gpt2"])
    shape = {"dp": 1, "ep": 2}
    shards = {tuple({"dp": 0, "ep": e}.items()):
              shard_state(state, cfg, shape, {"dp": 0, "ep": e})
              for e in range(2)}
    assert shards[(("dp", 0), ("ep", 1))]["h0.mlp.moe.experts.w1"].shape[0] \
        == 2
    back = gather_state(shards, cfg, shape)
    for k, v in state.items():
        from hetu_tpu_torch.models.generate import _Params
        np.testing.assert_array_equal(back[_Params._norm(k)], v)


def _update_gap(got, want, init):
    """The largest weight difference over the largest update."""
    num = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    den = max(float(np.abs(want[k] - init[k]).max()) for k in want)
    return num / den
