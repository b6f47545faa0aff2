"""The port's one-GPU training step against the JAX package's, on the CPU.

Both graphs are built through the same entry points (``graph`` ->
placeholders -> ``GPTLMHeadModel`` -> ``AdamOptimizer.minimize`` ->
``run``) for a tiny LLaMA-style and a tiny GPT-2-style config; the
weights are built by the JAX model and carried across with
``models.convert.load_state``.  In fp32: logits and loss within 1e-5,
every parameter gradient within 1e-4, and a 3-step Adam run with two
micro-batches within 1e-5 (losses and final parameters) -- the two sides
sum in different orders, nothing else.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import hetu_tpu as jht
from hetu_tpu import optim as joptim
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPTLMHeadModel
import hetu_tpu_torch as ht
from hetu_tpu_torch import optim
from hetu_tpu_torch.ops import functional as ops
from hetu_tpu_torch.graph import parameter
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
from hetu_tpu_torch.models.convert import (load_state, state_from_numpy,
                                           state_numpy)
from hetu_tpu_torch.models.generate import _Params, generate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the tiny configs of tests/test_torch_generate.py
CONFIGS = {
    "llama": dict(vocab_size=97, hidden_size=32, num_layers=2,
                  num_heads=4, num_kv_heads=2, max_seq_len=64, sp=False,
                  dropout=0.0, position="rotary", norm="rmsnorm",
                  activation="swiglu"),
    "gpt2": dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
                 max_seq_len=64, sp=False, dropout=0.0, position="learned",
                 norm="layernorm", activation="gelu"),
}
B, S = 4, 16


def _build_state(cfg, seed=3):
    jht.set_seed(seed)
    with jht.graph("eager", create_new=True):
        model = JaxGPTLMHeadModel(cfg)
        model.logits(np.zeros((1, 4), np.int32))
        return {k: np.asarray(v) for k, v in model.state_dict().items()}


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 97, (B, S)).astype(np.int32),
            rng.randint(0, 97, (B, S)).astype(np.int32))


def _jax_graph(kw, state, dtype="float32", lr=1e-2):
    with jht.graph("define_and_run", create_new=True) as g:
        ids = jht.placeholder("int32", (B, S), name="input_ids")
        labels = jht.placeholder("int32", (B, S), name="labels")
        model = JaxGPTLMHeadModel(JaxGPTConfig(**kw, dtype=dtype))
        loss = model(ids, labels)
        logits = model.logits(ids)
        xs = g.trainable_variables
        grads = g.make_gradients(loss, xs)
        train_op = joptim.AdamOptimizer(lr=lr).minimize(loss, var_list=xs)
        if state is not None:
            model.load_state_dict(state)
    return dict(g=g, ids=ids, labels=labels, model=model, loss=loss,
                logits=logits, xs=xs, grads=grads, train_op=train_op)


def _port_graph(kw, state, dtype="float32", lr=1e-2):
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        ids = ht.placeholder("int32", (B, S), name="input_ids")
        labels = ht.placeholder("int32", (B, S), name="labels")
        model = GPTLMHeadModel(GPTConfig(**kw, dtype=dtype))
        loss = model(ids, labels)
        logits = model.logits(ids)
        xs = g.trainable_variables
        grads = g.make_gradients(loss, xs)
        train_op = optim.AdamOptimizer(lr=lr).minimize(loss, var_list=xs)
        if state is not None:
            load_state(model, state)
    return dict(g=g, ids=ids, labels=labels, model=model, loss=loss,
                logits=logits, xs=xs, grads=grads, train_op=train_op)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    kw = CONFIGS[request.param]
    state = _build_state(JaxGPTConfig(**kw), seed=5)
    return request.param, kw, state


def test_logits_and_loss_within_1e5(pair):
    _, kw, state = pair
    x, y = _batch()
    j, p = _jax_graph(kw, state), _port_graph(kw, state)
    jl, jloss = j["g"].run([j["logits"], j["loss"]],
                           feed_dict={j["ids"]: x, j["labels"]: y})
    pl, ploss = p["g"].run([p["logits"], p["loss"]],
                           feed_dict={p["ids"]: x, p["labels"]: y})
    assert pl.shape == (B, S, 97) and pl.dtype == torch.float32
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(ploss), float(np.asarray(jloss)),
                               rtol=1e-5)


def test_every_gradient_within_1e4(pair):
    _, kw, state = pair
    x, y = _batch(1)
    j, p = _jax_graph(kw, state), _port_graph(kw, state)
    jg = j["g"].run(j["grads"], feed_dict={j["ids"]: x, j["labels"]: y})
    pg = p["g"].run(p["grads"], feed_dict={p["ids"]: x, p["labels"]: y})
    jnames = [t.name for t in j["xs"]]
    pnames = [t.name for t in p["xs"]]
    assert jnames == pnames and len(pnames) > 10
    for name, a, b in zip(pnames, pg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4, err_msg=name)


def test_three_adam_steps_with_two_micro_batches(pair):
    _, kw, state = pair
    x, y = _batch(2)
    # Adam moves every weight by about lr whatever its gradient's size, so
    # a gradient that cancels to ~1e-7 (a bias) turns last-digit sum-order
    # differences into differences of up to lr: lr 1e-3 keeps them < 1e-5
    j, p = _jax_graph(kw, state, lr=1e-3), _port_graph(kw, state, lr=1e-3)
    jl, pl = [], []
    for _ in range(3):
        l, _u = j["g"].run(j["loss"], [j["loss"], j["train_op"]],
                           {j["ids"]: x, j["labels"]: y}, num_micro_batches=2)
        jl.append(float(np.asarray(l)))
        l, u = p["g"].run(p["loss"], [p["loss"], p["train_op"]],
                          {p["ids"]: x, p["labels"]: y}, num_micro_batches=2)
        assert u is None and l.ndim == 0
        pl.append(float(l))
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[-1] < pl[0]
    want = {_Params._norm(k): np.asarray(v)
            for k, v in j["model"].state_dict().items()}
    got = state_numpy(p["model"])
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-5,
                                   err_msg=name)


# the MLP activations the training model takes besides gelu and swiglu:
# a 1-layer GPT (vocab 64, hidden 32, 4 heads, fp32, batch 2, seq 8)
ACT_KW = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=4,
              max_seq_len=16, sp=False, dropout=0.0, position="learned",
              norm="layernorm")


def _one_adam_step(graph, placeholder, model_cls, cfg, opt, state, load,
                   x, y):
    """Loss before and after one Adam step, and the trained model."""
    with graph("define_and_run", create_new=True,
               **({"device": "cpu"} if graph is ht.graph else {})) as g:
        ids = placeholder("int32", (2, 8), name="input_ids")
        labels = placeholder("int32", (2, 8), name="labels")
        model = model_cls(cfg)
        loss = model(ids, labels)
        train_op = opt(lr=1e-3).minimize(loss)
        load(model, state)
    losses = [float(np.asarray(g.run(loss, [loss, train_op],
                                     {ids: x, labels: y})[0]))
              for _ in range(2)]
    return losses, model


@pytest.mark.parametrize("activation", ["relu", "silu"])
def test_relu_and_silu_mlps_train_as_in_jax(activation):
    """The training MLP takes relu and silu as the reference does: one
    Adam step from the JAX model's weights, losses within 2e-5 of JAX's
    and every trained weight within 1e-5."""
    kw = dict(ACT_KW, activation=activation)
    state = _build_state(JaxGPTConfig(**kw), seed=5)
    rng = np.random.RandomState(0)
    x = rng.randint(0, 64, (2, 8)).astype(np.int32)
    y = rng.randint(0, 64, (2, 8)).astype(np.int32)
    jl, jmodel = _one_adam_step(
        jht.graph, jht.placeholder, JaxGPTLMHeadModel, JaxGPTConfig(**kw),
        joptim.AdamOptimizer, state, lambda m, s: m.load_state_dict(s),
        x, y)
    pl, pmodel = _one_adam_step(
        ht.graph, ht.placeholder, GPTLMHeadModel, GPTConfig(**kw),
        optim.AdamOptimizer, state, load_state, x, y)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=2e-5)
    assert pl[1] < pl[0]
    want = {_Params._norm(k): np.asarray(v)
            for k, v in jmodel.state_dict().items()}
    got = state_numpy(pmodel)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-5,
                                   err_msg=name)


def _attention_input_dtypes(graph_ops, name_of):
    return [tuple(name_of(t.dtype) for t in node.inputs[:3])
            for node in graph_ops if node.op_type == "attention"]


@pytest.mark.parametrize("which,want", [
    ("llama", ("float32", "float32", "bfloat16")),
    ("gpt2", ("bfloat16", "bfloat16", "bfloat16"))])
def test_bf16_attention_inputs_have_the_jax_dtypes(which, want):
    kw = CONFIGS[which]
    j = _jax_graph(kw, None, dtype="bfloat16")
    p = _port_graph(kw, None, dtype="bfloat16")
    jd = _attention_input_dtypes(j["g"].ops,
                                 lambda d: str(np.dtype(d.to_jnp())))
    pd = _attention_input_dtypes(p["g"].ops,
                                 lambda d: str(d).replace("torch.", ""))
    assert pd == jd
    assert pd and all(d == want for d in pd)


def test_use_flash_on_the_cpu_gives_the_sdpa_loss_and_grads():
    rng = np.random.RandomState(4)
    vals = [rng.randn(2, 32, 2, 64).astype(np.float32) for _ in range(3)]
    results = []
    for use_flash in (False, True):
        with ht.graph("define_and_run", create_new=True, device="cpu") as g:
            q, k, v = (parameter(a, name=n) for a, n in zip(vals, "qkv"))
            out = ops.attention(q, k, v, causal=True, use_flash=use_flash)
            loss = ops.reduce_sum(out * out)
            grads = g.make_gradients(loss, [q, k, v])
            results.append(g.run([loss] + grads))
    for a, b in zip(*results):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_trained_weights_feed_generate():
    kw = CONFIGS["llama"]
    p = _port_graph(kw, _build_state(JaxGPTConfig(**kw)))
    x, y = _batch(3)
    p["g"].run(p["loss"], [p["loss"], p["train_op"]],
               {p["ids"]: x, p["labels"]: y})
    cfg = GPTConfig(**kw)
    st = state_from_numpy(state_numpy(p["model"]), cfg, device="cpu")
    toks = generate(st, cfg, [[5, 17, 2]], 4, device="cpu")
    assert toks.shape == (1, 7)


# ---------------------------------------------------------------------------
# graph probes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    return _port_graph(CONFIGS["gpt2"], None)


def test_probe_wrong_feed_shape_names_the_placeholder(tiny):
    x, y = _batch()
    with pytest.raises(ValueError, match="labels"):
        tiny["g"].run([tiny["loss"]], feed_dict={tiny["ids"]: x,
                                                 tiny["labels"]: y[:, :8]})
    with pytest.raises(ValueError, match="input_ids has rank 1"):
        tiny["g"].run([tiny["loss"]], feed_dict={tiny["ids"]: x[0],
                                                 tiny["labels"]: y})


def test_probe_missing_feed(tiny):
    x, _ = _batch()
    with pytest.raises(ValueError, match="placeholder labels not fed"):
        tiny["g"].run([tiny["loss"]], feed_dict={tiny["ids"]: x})


def test_probe_micro_batches_must_divide_the_batch(tiny):
    x, y = _batch()
    with pytest.raises(ValueError, match="not divisible by 3"):
        tiny["g"].run(tiny["loss"], [tiny["loss"], tiny["train_op"]],
                      {tiny["ids"]: x, tiny["labels"]: y},
                      num_micro_batches=3)


def test_probe_arity_and_plan_pool(tiny):
    x, y = _batch()
    g = tiny["g"]
    feeds = {tiny["ids"]: x, tiny["labels"]: y}
    l, u = g.run(tiny["loss"], [tiny["loss"], tiny["train_op"]], feeds,
                 num_micro_batches=2)
    assert u is None and torch.isfinite(l)
    n = len(g._plan_pool)
    for _ in range(2):
        g.run(tiny["loss"], [tiny["loss"], tiny["train_op"]], feeds,
              num_micro_batches=2)
    assert len(g._plan_pool) == n
    u, l = g.run(tiny["loss"], [tiny["train_op"], tiny["loss"]], feeds)
    assert u is None and l.ndim == 0
    (l,) = g.run([tiny["loss"]], feed_dict=feeds, run_level="compute_only")
    assert l.ndim == 0


def test_probe_refusals():
    with pytest.raises(ValueError, match="unknown dtype"):
        with ht.graph("define_and_run", create_new=True, device="cpu"):
            ht.placeholder("float8", (2, 2))
    # without a mesh a partition spec shards nothing (meshes:
    # tests/test_torch_parallel.py)
    with ht.graph("define_and_run", create_new=True, device="cpu"):
        t = ht.parallel_placeholder("int32", (8, 16), pspec=("dp", None))
        assert t.shape == (8, 16)
        ht.parallel_placeholder("int32", (8, 16), pspec=(None, None))
    # strategies are ported (tests/test_torch_switch.py): num_strategy
    # sets the graph's count
    with ht.graph("define_and_run", create_new=True, device="cpu",
                  num_strategy=2) as g:
        assert g.num_strategy == 2
    with pytest.raises(ValueError, match="flat_state"):
        optim.AdamOptimizer(lr=1e-3, zero=0, flat_state=True,
                            grad_comm="fp32")
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        with pytest.raises(ValueError, match="new mesh"):
            g.switch_strategy(None)
        # the numeric sentry is ported (tests/test_torch_resilience.py):
        # a known kind arms the next step's code, another is refused
        g.inject_numeric_fault("grad_nan")
        assert g._sentry_next_code == 1
        with pytest.raises(ValueError, match="unknown numeric fault"):
            g.inject_numeric_fault("bit_flip")
        # shape buckets and the grad run level are ported (test_torch_graph)
        g.set_shape_buckets([16, 32])
        assert g.run([], run_level="grad") == []
        with pytest.raises(ValueError, match="unknown graph kind"):
            ht.graph("define_by_value", create_new=True, device="cpu")
    # MoE trains (tests/test_torch_moe.py holds it to JAX): its layers
    # replace the MLP
    with ht.graph("define_and_run", create_new=True, device="cpu"):
        m = GPTLMHeadModel(GPTConfig(**CONFIGS["gpt2"], num_experts=2))
        assert "transformer.h.1.mlp.moe.experts.w1" in dict(
            m.named_parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ht.graph("define_and_run", create_new=True)


def test_quickstart_reads_as_in_the_jax_package():
    """The README's training Quickstart, through hetu_tpu_torch."""
    x, y = _batch()
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        ids = ht.parallel_placeholder("int32", (B, S))
        labels = ht.parallel_placeholder("int32", (B, S))
        model = GPTLMHeadModel(GPTConfig(**CONFIGS["gpt2"]))
        loss = model(ids, labels)
        train_op = ht.optim.AdamOptimizer(lr=3e-4).minimize(loss)
        l, _ = g.run(loss, [loss, train_op], {ids: x, labels: y},
                     num_micro_batches=2)
    assert torch.isfinite(l)


def test_importing_the_training_port_loads_no_jax():
    code = ("import sys, hetu_tpu_torch, hetu_tpu_torch.graph, "
            "hetu_tpu_torch.optim, hetu_tpu_torch.ops.flash_attention, "
            "hetu_tpu_torch.models.gpt, hetu_tpu_torch.nn\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'hetu_tpu')]\n"
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    assert out == "[]"


def test_promoted_matmul_and_sparse_nll_match_autograd():
    """The memory-lean mixed-dtype matmul and cross entropy give the
    gradients of the plain torch expressions."""
    from hetu_tpu_torch.ops.functional import _matmul, _softmax_ce
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(2, 5, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(6, 8).astype(np.float32)).bfloat16()
    t = torch.from_numpy(rng.randint(0, 6, (2, 5)).astype(np.int32))
    t[0, 1] = -100
    got_in = (x.clone().requires_grad_(True), w.clone().requires_grad_(True))
    ref_in = (x.clone().requires_grad_(True), w.clone().requires_grad_(True))
    got = _softmax_ce(_matmul(*got_in, trans_b=True), t, ignore_index=-100)
    lg = torch.matmul(ref_in[0], ref_in[1].float().t())
    lp = torch.log_softmax(lg, -1)
    keep = t != -100
    picked = torch.gather(lp, -1, torch.where(keep, t, 0).long()[..., None])
    ref = -(picked[..., 0] * keep).sum() / keep.sum()
    np.testing.assert_allclose(got.item(), ref.item(), rtol=1e-6)
    for a, b in zip(torch.autograd.grad(got, got_in),
                    torch.autograd.grad(ref, ref_in)):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_micro_batch_accumulation_with_shared_and_expanded_grads():
    """Two parameters that receive one gradient tensor (a + b), and one
    whose gradient is an expanded view (sum(c)), accumulate over
    micro-batches as the JAX graph's sum / M does."""
    x = np.arange(8, dtype=np.float32).reshape(4, 2)
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        a = parameter(np.zeros((), np.float32), name="a")
        b = parameter(np.zeros((), np.float32), name="b")
        c = parameter(np.zeros((2,), np.float32), name="c")
        xin = ht.placeholder("float32", (4, 2), name="x")
        loss = ops.reduce_sum(xin * (a + b)) + ops.reduce_sum(c)
        grads = g.make_gradients(loss, [a, b, c])
        for m in (1, 2, 4):
            ga, gb, gc = g.run(grads, feed_dict={xin: x},
                               num_micro_batches=m)
            # scalar fetches average over the micro-batches
            assert ga.item() == gb.item() == x.sum() / m
            assert torch.equal(gc, torch.ones(2))
        op = optim.AdamOptimizer(lr=0.1).minimize(loss, var_list=[a, b, c])
        g.run(loss, [loss, op], {xin: x}, num_micro_batches=2)
    # one Adam step moves every element by lr against its gradient's sign
    np.testing.assert_allclose(a.numpy(), -0.1, rtol=1e-5)
    np.testing.assert_allclose(b.numpy(), -0.1, rtol=1e-5)
    np.testing.assert_allclose(c.numpy(), [-0.1, -0.1], rtol=1e-5)
