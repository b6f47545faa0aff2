"""The port's AMP, recompute and fused cross entropy against the JAX
package's, on the CPU.

- ``autocast`` gives every op of JAX's tables JAX's output dtype;
- ``GradScaler``'s state sequence over finite and non-finite steps equals
  JAX's, in a graph too, and a skipped step leaves parameters, Adam's
  moments and its step count bitwise unchanged;
- ``fused_linear_cross_entropy``: loss, dx and dw against JAX's (chunks
  1, 3 and 8, ``ignore_index``, mean and sum), and a tied-head GPT with
  ``fused_lm_ce`` against JAX's model;
- ``recompute`` (every policy) and ``cpu_offload`` train to the plain
  step's weights, dropout > 0 included, and the plan key holds the
  policy and the offload flag.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import hetu_tpu as jht
from hetu_tpu import ops as jops
from hetu_tpu import optim as joptim
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPTLMHeadModel
from hetu_tpu.ops.fused_ce import fused_linear_cross_entropy as jax_fce
import hetu_tpu_torch as ht
from hetu_tpu_torch import optim
from hetu_tpu_torch.graph import parameter
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
from hetu_tpu_torch.models.convert import load_state
from hetu_tpu_torch.ops import functional as ops
from hetu_tpu_torch.ops.fused_ce import (fused_linear_cross_entropy,
                                         product_route)


def _jname(dt):
    return str(np.dtype(dt.to_jnp()))


def _pname(dt):
    return str(dt).replace("torch.", "")


# ---------------------------------------------------------------------------
# autocast
# ---------------------------------------------------------------------------

def _autocast_graph(pkg, graph_kw, ops_mod, param):
    """Every op type of JAX's tables the port records, built under
    ``autocast(bfloat16)`` from fp32 inputs; (op type, output dtype)."""
    with pkg.graph("define_and_run", create_new=True, **graph_kw) as g:
        x = pkg.placeholder("float32", (2, 8, 16), name="x")
        lbl = pkg.placeholder("int32", (2, 8), name="lbl")
        w = param(np.ones((16, 16), np.float32) * 0.1, "w")
        b = param(np.zeros((16,), np.float32), "b")
        s = param(np.ones((16,), np.float32), "s")
        head = param(np.ones((10, 16), np.float32) * 0.1, "head")
        with pkg.autocast("bfloat16"):
            h = ops_mod.matmul(x, w)
            h = ops_mod.linear(h, w, b)
            q = ops_mod.reshape(h, (2, 8, 2, 8))
            a = ops_mod.attention(q, q, q, causal=True)
            h = ops_mod.layer_norm(ops_mod.reshape(a, (2, 8, 16)), s, b)
            h = ops_mod.rms_norm(h, s)
            logits = ops_mod.matmul(h, head, trans_b=True)
            ce = ops_mod.softmax_cross_entropy(logits, lbl)
            fce = ops_mod.fused_lm_cross_entropy(h, head, lbl)
            ops_mod.add(ce, fce)
    kinds = {"matmul", "linear", "attention", "layer_norm", "rms_norm",
             "softmax_cross_entropy", "fused_lm_cross_entropy", "add"}
    return [(n.op_type, n.outputs[0].dtype) for n in g.ops
            if n.op_type in kinds]


def test_autocast_dtypes_equal_jax_tables():
    want = [(k, _jname(d)) for k, d in _autocast_graph(
        jht, {}, jops, lambda v, n: jht.parameter(v, name=n))]
    got = [(k, _pname(d)) for k, d in _autocast_graph(
        ht, {"device": "cpu"}, ops, lambda v, n: parameter(v, name=n))]
    assert got == want
    assert dict(got)["matmul"] == "bfloat16"
    assert dict(got)["layer_norm"] == "float32"


def test_autocast_loss_of_an_fp32_model_near_jax():
    kw = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=16, dropout=0.0)
    jht.set_seed(2)
    with jht.graph("eager", create_new=True):
        m = JaxGPTLMHeadModel(JaxGPTConfig(**kw))
        m.logits(np.zeros((1, 4), np.int32))
        state = {k: np.asarray(v) for k, v in m.state_dict().items()}
    x = np.random.RandomState(0).randint(0, 64, (2, 16)).astype(np.int32)
    with jht.graph("define_and_run", create_new=True) as g:
        ids = jht.placeholder("int32", (2, 16), name="ids")
        with jht.autocast("bfloat16"):
            model = JaxGPTLMHeadModel(JaxGPTConfig(**kw))
            loss = model(ids, ids)
        model.load_state_dict(state)
        jl = float(np.asarray(g.run([loss], feed_dict={ids: x})[0]))
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        ids = ht.placeholder("int32", (2, 16), name="ids")
        with ht.autocast("bfloat16"):
            model = GPTLMHeadModel(GPTConfig(**kw))
            loss = model(ids, ids)
        load_state(model, state)
        pl = float(g.run([loss], feed_dict={ids: x})[0])
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(pl, jl, rtol=1e-2)


# ---------------------------------------------------------------------------
# GradScaler
# ---------------------------------------------------------------------------

def test_scaler_state_sequence_equals_jax():
    kw = dict(init_scale=256.0, growth_factor=2.0, backoff_factor=0.5,
              growth_interval=2)
    js, ps = jht.GradScaler(**kw), ht.GradScaler(**kw)
    jst, pst = js.init_state(), ps.init_state("cpu")
    for finite in (True, True, True, False, True, True, False, False, True):
        jst = js.update_state(jst, jnp.bool_(finite))
        pst = ps.update_state(pst, torch.tensor(finite))
        assert float(pst["scale"]) == float(jst["scale"])
        assert int(pst["good_steps"]) == int(jst["good_steps"])
    g = [torch.tensor([1.0, 2.0]), torch.tensor([4], dtype=torch.int32)]
    un = ps.unscale_grads(g, pst)
    np.testing.assert_array_equal(un[0].numpy(), np.asarray(
        js.unscale_grads([jnp.array([1.0, 2.0])], jst)[0]))
    assert un[1] is g[1]


def _scaler_graph(pkg, graph_kw, ops_mod, param, make_opt, scaler):
    with pkg.graph("define_and_run", create_new=True, **graph_kw) as g:
        x = pkg.placeholder("float32", (4, 8), name="x")
        w = param(np.linspace(-1, 1, 32).reshape(8, 4).astype(np.float32),
                  "w")
        y = ops_mod.reduce_sum(ops_mod.mul(ops_mod.matmul(x, w),
                                           ops_mod.matmul(x, w)))
        op = make_opt().minimize(y, grad_scaler=scaler)
    return g, x, w, y, op


def test_scaler_in_a_graph_equals_jax_and_skips_without_residue():
    rng = np.random.RandomState(0)
    feeds = [rng.randn(4, 8).astype(np.float32) for _ in range(6)]
    feeds[2] = feeds[2].copy()
    feeds[2][1, 3] = np.inf
    feeds[4] = feeds[4].copy()
    feeds[4][0, 0] = np.nan
    kw = dict(init_scale=1024.0, growth_interval=2)
    js, ps = jht.GradScaler(**kw), ht.GradScaler(**kw)
    jg, jx, jw, jy, jop = _scaler_graph(
        jht, {}, jops, lambda v, n: jht.parameter(v, name=n),
        lambda: joptim.AdamOptimizer(lr=1e-2), js)
    pg, px, pw, py, pop = _scaler_graph(
        ht, {"device": "cpu"}, ops, lambda v, n: parameter(v, name=n),
        lambda: optim.AdamOptimizer(lr=1e-2), ps)
    opt = pop.producer.attrs["optimizer"]
    for i, f in enumerate(feeds):
        before = ({k: v.clone() for k, v in opt.state_dict().items()
                   if isinstance(v, torch.Tensor)},
                  {k: {t: v.clone() for t, v in d.items()}
                   for k, d in opt.state_dict().items() if isinstance(d, dict)},
                  pw.get_data().clone())
        jl = jg.run(jy, [jy, jop], {jx: f})[0]
        pl = pg.run(py, [py, pop], {px: f})[0]
        assert ps.scale == js.scale
        np.testing.assert_allclose(pw.get_data().numpy(),
                                   np.asarray(jg.get_tensor_value(jw)),
                                   rtol=1e-5, atol=1e-6)
        if np.isfinite(f).all():
            np.testing.assert_allclose(float(pl), float(np.asarray(jl)),
                                       rtol=1e-5)
        elif i > 0:
            # skipped: parameters, moments and step bitwise unchanged
            assert torch.equal(pw.get_data(), before[2])
            for k, v in before[0].items():
                assert torch.equal(opt._state[k], v), k
            for k, d in before[1].items():
                for t, v in d.items():
                    assert torch.equal(opt._state[k][t], v), k
    assert float(opt._state["step"]) == 4.0


def test_disabled_scaler_is_inert():
    scaler = ht.GradScaler(enabled=False)
    g, x, w, y, op = _scaler_graph(
        ht, {"device": "cpu"}, ops, lambda v, n: parameter(v, name=n),
        lambda: optim.SGDOptimizer(lr=0.1), scaler)
    X = np.ones((4, 8), np.float32)
    g.run(y, [y, op], {x: X})
    g.run(y, [y, op], {x: X})
    assert scaler._state is None


# ---------------------------------------------------------------------------
# fused cross entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunks", [1, 3, 8])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("ignore", [False, True])
def test_fused_ce_equals_jax(chunks, reduction, ignore):
    rng = np.random.RandomState(chunks)
    n, h, v = 24, 16, 37
    x = rng.randn(n, h).astype(np.float32)
    w = (rng.randn(v, h) * 0.3).astype(np.float32)
    lbl = rng.randint(0, v, n).astype(np.int32)
    if ignore:
        lbl[::5] = -100
    jl, (jdx, jdw) = jax.value_and_grad(
        lambda a, b: jax_fce(a, b, jnp.asarray(lbl), -100, chunks,
                             reduction), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    pl = fused_linear_cross_entropy(xt, wt, torch.tensor(lbl), -100, chunks,
                                    reduction)
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(jl), rtol=2e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=2e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=2e-6)
    # the unfused softmax CE gives the same loss
    ref = torch.nn.functional.cross_entropy(
        torch.tensor(x) @ torch.tensor(w).t(), torch.tensor(lbl).long(),
        ignore_index=-100, reduction=reduction)
    np.testing.assert_allclose(pl.item(), float(ref), rtol=1e-5)


def test_fused_ce_bf16_products_take_fp32_results_on_the_cpu():
    assert product_route(torch.bfloat16, "cpu") == "fp32_operands"
    assert product_route(torch.float32, "cpu") == "fp32"
    rng = np.random.RandomState(5)
    x = torch.tensor(rng.randn(16, 8), dtype=torch.bfloat16)
    w = torch.tensor(rng.randn(11, 8), dtype=torch.bfloat16)
    lbl = torch.tensor(rng.randint(0, 11, 16))
    got = fused_linear_cross_entropy(x, w, lbl, num_chunks=4)
    want = jax_fce(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                   jnp.asarray(w.float().numpy(), jnp.bfloat16),
                   jnp.asarray(lbl.numpy()), -100, 4, "mean")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_fused_ce_bf16_groups_hold_fp32_and_refuse_bf16_logits():
    """The card's precision gate at a small size: each 64-token group's
    loss (the op's sum) of bf16 operands within 2e-6 of an fp32 cross
    entropy and of JAX's op, and a route that rounds the chunk logits to
    bf16 beyond it."""
    from unittest import mock
    from hetu_tpu_torch.ops import fused_ce
    rng = np.random.RandomState(7)
    n, h, v, grp = 512, 64, 3000, 64
    x = torch.nn.functional.layer_norm(
        torch.tensor(rng.randn(n, h), dtype=torch.float32), (h,)).bfloat16()
    w = torch.tensor(rng.randn(v, h) * 0.1).bfloat16()
    lbl = torch.tensor(rng.randint(0, v, n))
    ref = torch.nn.functional.cross_entropy(
        x.float() @ w.float().t(), lbl, reduction="none").reshape(-1, grp)
    ref = ref.sum(1)
    xg, lg = x.reshape(-1, grp, h), lbl.reshape(-1, grp)

    def groups():
        return torch.stack([fused_linear_cross_entropy(a, w, b,
                                                       reduction="sum")
                            for a, b in zip(xg, lg)])
    got = groups()
    jw = jnp.asarray(w.float().numpy(), jnp.bfloat16)
    want = np.array([float(jax_fce(jnp.asarray(a.float().numpy(),
                                                jnp.bfloat16), jw,
                                   jnp.asarray(b.numpy()), -100, 8, "sum"))
                     for a, b in zip(xg, lg)])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6)
    assert float(((got - ref).abs() / ref).max()) <= 2e-6
    with mock.patch.object(fused_ce, "_mm32",
                           lambda a, b: torch.mm(a, b).float()):
        bad = groups()
    assert float(((bad - ref).abs() / ref).max()) > 2e-6


def test_fused_ce_refuses_reduction_none():
    with pytest.raises(ValueError, match="reduction"):
        fused_linear_cross_entropy(torch.ones(2, 3), torch.ones(4, 3),
                                   torch.zeros(2, dtype=torch.long),
                                   reduction="none")


@pytest.mark.parametrize("tie", [True, False])
def test_fused_lm_ce_model_equals_jax(tie):
    kw = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=16, dropout=0.0, tie_embeddings=tie,
              fused_lm_ce=True)
    jht.set_seed(4)
    with jht.graph("eager", create_new=True):
        m = JaxGPTLMHeadModel(JaxGPTConfig(**kw))
        m.logits(np.zeros((1, 4), np.int32))
        state = {k: np.asarray(v) for k, v in m.state_dict().items()}
    rng = np.random.RandomState(1)
    x = rng.randint(0, 64, (2, 16)).astype(np.int32)
    y = rng.randint(0, 64, (2, 16)).astype(np.int32)
    y[0, :3] = -100
    with jht.graph("define_and_run", create_new=True) as g:
        ids = jht.placeholder("int32", (2, 16), name="ids")
        lab = jht.placeholder("int32", (2, 16), name="lab")
        model = JaxGPTLMHeadModel(JaxGPTConfig(**kw))
        loss = model(ids, lab)
        xs = g.trainable_variables
        grads = g.make_gradients(loss, xs)
        model.load_state_dict(state)
        jout = g.run([loss] + grads, feed_dict={ids: x, lab: y})
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        ids = ht.placeholder("int32", (2, 16), name="ids")
        lab = ht.placeholder("int32", (2, 16), name="lab")
        model = GPTLMHeadModel(GPTConfig(**kw))
        loss = model(ids, lab)
        assert loss.producer.op_type == "fused_lm_cross_entropy"
        pxs = g.trainable_variables
        grads = g.make_gradients(loss, pxs)
        load_state(model, state)
        pout = g.run([loss] + grads, feed_dict={ids: x, lab: y})
    assert [t.name for t in pxs] == [t.name for t in xs]
    np.testing.assert_allclose(float(pout[0]), float(np.asarray(jout[0])),
                               rtol=1e-5)
    for t, a, b in zip(pxs, pout[1:], jout[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg=t.name)


# ---------------------------------------------------------------------------
# recompute and offload
# ---------------------------------------------------------------------------

KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
          max_seq_len=16)


def _train(ctx, dropout=0.0, steps=2, micro=1, fused=False):
    """Two SGD steps (lr 1: the weights move by the gradients) of a tiny
    GPT from seed-0 weights; the final weights and losses."""
    with ht.graph("define_and_run", create_new=True, device="cpu",
                  seed=1) as g:
        ids = ht.placeholder("int32", (4, 16), name="ids")
        lab = ht.placeholder("int32", (4, 16), name="lab")
        model = GPTLMHeadModel(GPTConfig(**KW, dropout=dropout,
                                         fused_lm_ce=fused))
        loss = model(ids, lab)
        op = optim.SGDOptimizer(lr=1.0).minimize(loss)
    torch.manual_seed(0)
    load_state(model, {n: torch.randn(p.shape) * 0.05
                       for n, p in model.named_parameters()})
    rng = np.random.RandomState(3)
    x = rng.randint(0, 64, (4, 16)).astype(np.int32)
    losses = []
    with ctx(g) if ctx is not None else contextlib.nullcontext():
        for _ in range(steps):
            losses.append(float(g.run(loss, [loss, op], {ids: x, lab: x},
                                      num_micro_batches=micro)[0]))
    return losses, {n: p.get_data().clone()
                    for n, p in model.named_parameters()}, g


CTXS = {
    "nothing_saveable": lambda g: ht.recompute(graph=g),
    "dots_saveable": lambda g: ht.recompute("dots_saveable", graph=g),
    "dots_with_no_batch_dims_saveable": lambda g: ht.recompute(
        "dots_with_no_batch_dims_saveable", graph=g),
    "everything_saveable": lambda g: ht.recompute("everything_saveable",
                                                  graph=g),
    "cpu_offload": lambda g: ht.cpu_offload(graph=g),
}


@pytest.mark.parametrize("dropout", [0.0, 0.2])
@pytest.mark.parametrize("mode", sorted(CTXS))
def test_recompute_and_offload_train_as_the_plain_step(mode, dropout):
    base_l, base_w, _ = _train(None, dropout, micro=2)
    l, w, g = _train(CTXS[mode], dropout, micro=2)
    assert l == base_l
    for n in base_w:
        np.testing.assert_allclose(w[n].numpy(), base_w[n].numpy(),
                                   rtol=0, atol=1e-6, err_msg=n)
    (entry,) = g._plan_pool.values()
    if mode.endswith("saveable") and mode != "everything_saveable":
        # two regions a layer and the head; the forward ran through them
        assert len(entry.regions) == 2 * KW["num_layers"] + 1
    else:
        assert entry.regions is None


def test_recompute_with_fused_ce():
    base_l, base_w, _ = _train(None, fused=True)
    l, w, _ = _train(CTXS["nothing_saveable"], fused=True)
    np.testing.assert_allclose(l, base_l, rtol=1e-6)
    for n in base_w:
        np.testing.assert_allclose(w[n].numpy(), base_w[n].numpy(),
                                   rtol=0, atol=1e-6, err_msg=n)


def test_recompute_redraws_no_mask():
    """With dropout under recompute the generator advances as in the plain
    step (the recomputation reuses the forward's draw)."""
    _, _, g0 = _train(None, dropout=0.2)
    _, _, g1 = _train(CTXS["nothing_saveable"], dropout=0.2)
    assert torch.equal(g0.generator.get_state(), g1.generator.get_state())


def test_recompute_refuses_explicit_gradients():
    """A recompute request on a plan that fetches ``make_gradients``
    raises instead of running the plain step."""
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        x = ht.placeholder("float32", (4,), name="x")
        w = parameter(np.ones((4,), np.float32), name="w")
        y = ops.reduce_sum(ops.mul(x, w))
        (dw,) = g.make_gradients(y, [w])
    X = np.ones((4,), np.float32)
    np.testing.assert_array_equal(g.run([dw], feed_dict={x: X})[0].numpy(),
                                  X)
    with ht.recompute(graph=g), \
            pytest.raises(NotImplementedError, match="explicit gradients"):
        g.run([dw], feed_dict={x: X})


def test_plan_key_holds_policy_and_offload():
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        x = ht.placeholder("float32", (4,), name="x")
        w = parameter(np.ones((4,), np.float32), name="w")
        y = ops.reduce_sum(ops.mul(x, w))
        op = optim.SGDOptimizer(lr=0.1).minimize(y)
    X = np.ones((4,), np.float32)
    g.run(y, [y, op], {x: X})
    assert len(g._plan_pool) == 1
    with ht.recompute(graph=g):
        g.run(y, [y, op], {x: X})
    assert len(g._plan_pool) == 2
    with ht.recompute("dots_saveable", graph=g):
        g.run(y, [y, op], {x: X})
    assert len(g._plan_pool) == 3
    with ht.cpu_offload(graph=g):
        g.run(y, [y, op], {x: X})
    assert len(g._plan_pool) == 4
    g.run(y, [y, op], {x: X})
    assert len(g._plan_pool) == 4
    assert g._recompute_policy is None and g._offload is False
    with pytest.raises(ValueError, match="unknown recompute policy"):
        ht.recompute("sometimes")
    with ht.recompute(graph=g, multi_recompute=[False, False]):
        assert g._recompute_policy is None
