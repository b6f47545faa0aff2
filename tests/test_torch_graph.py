"""The port's graph layer against the JAX package's, on the CPU.

The cases of ``tests/test_graph.py``'s graph layer (eager graphs,
define-by-run graphs, run levels, the plan pool, symbolic and derived
dims, shape buckets, ``set_seed``), each run through both packages on
the same seeded numpy inputs and the JAX side's weights (carried across
by ``models.convert``), values within ``TOL`` = 2e-5 in fp32.  Also: the
GRAD-then-UPDATE sum with Adam and SGD, a symbolic-batch GPT trained on
shape buckets at one and two micro-batches (where the pad rows fill the
last micro-batch, whose mean the JAX package takes as it is), ``TOPO``
and ``ALLOC``, the symbolic sequence dim that the GPT model bakes, the
data types and devices, and the seed streams' invariants (the bits are
not JAX's threefry draws).
"""
import importlib

import numpy as np
import pytest
import torch

import hetu_tpu as jht
from hetu_tpu import nn as jnn
from hetu_tpu import optim as joptim
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPTLMHeadModel
import hetu_tpu_torch as ht
from hetu_tpu_torch import nn as pnn
from hetu_tpu_torch import optim as poptim
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
from hetu_tpu_torch.models.convert import load_module_state, load_state

jops = importlib.import_module("hetu_tpu.ops.functional")
pops = importlib.import_module("hetu_tpu_torch.ops.functional")
jdtype = importlib.import_module("hetu_tpu.core.dtype")
jdevice = importlib.import_module("hetu_tpu.core.device")
pgraph = importlib.import_module("hetu_tpu_torch.graph.graph")

TOL = 2e-5
CPU = {"device": "cpu"}
# each package with the keywords its graph() takes on the CPU
PKGS = {"jax": (jht, jnn, joptim, jops, {}),
        "port": (ht, pnn, poptim, pops, CPU)}
GPT_KW = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=64, sp=False, dropout=0.0, position="learned",
              norm="layernorm", activation="gelu")


def _np(x):
    """A numpy copy (the optimizers update variables in place)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy().copy() \
            if x.is_floating_point() else x.detach().cpu().numpy().copy()
    return np.array(x)


def _data(seed=0, n=16, d=8, classes=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d).astype(np.float32),
            rng.randint(0, classes, (n,)).astype(np.int32))


def _mlp_graph(pkg, opt, state=None, n=16):
    """An MLP classifier and its update op; the port's takes ``state``."""
    m, nn, optim, ops, kw = PKGS[pkg]
    with m.graph("define_and_run", create_new=True, **kw) as g:
        x = m.placeholder("float32", (n, 8), name="x")
        y = m.placeholder("int32", (n,), name="y")
        model = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
        loss = ops.softmax_cross_entropy(model(x), y)
        if opt == "adam":
            train_op = optim.AdamOptimizer(lr=0.01).minimize(loss)
        else:
            train_op = optim.SGDOptimizer(lr=0.1, momentum=0.9).minimize(loss)
        if state is not None:
            load_module_state(model, state)
    return g, x, y, model, loss, train_op


def _jax_state(model):
    return {k: np.asarray(v) for k, v in model.state_dict().items()}


def _params(model):
    return {k: _np(v.get_data()) for k, v in model.named_parameters()}


# ---------------------------------------------------------------------------
# eager graphs
# ---------------------------------------------------------------------------

class TestEager:
    def test_eager_module(self):
        x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
        with jht.graph("eager", create_new=True):
            jlin = jnn.Linear(4, 2)
            jy = np.asarray(jlin(x).numpy())
            state = _jax_state(jlin)
        with ht.graph("eager", create_new=True, device="cpu") as g:
            lin = pnn.Linear(4, 2)
            load_module_state(lin, state)
            y = lin(x)
            assert isinstance(g, ht.EagerGraph) and y._data is not None
            w, b = lin.weight.numpy(), lin.bias.numpy()
        np.testing.assert_allclose(y.numpy(), x @ w.T + b, rtol=1e-5)
        np.testing.assert_allclose(y.numpy(), jy, rtol=TOL, atol=TOL)

    def test_eager_gpt_logits_equal_jax(self):
        """A whole model's forward, op by op, against the JAX package's
        eager graph."""
        ids = np.random.RandomState(1).randint(0, 97, (2, 16)).astype(
            np.int32)
        with jht.graph("eager", create_new=True):
            jm = JaxGPTLMHeadModel(JaxGPTConfig(**GPT_KW))
            want = np.asarray(jm.logits(ids).numpy())
            state = _jax_state(jm)
        with ht.graph("eager", create_new=True, device="cpu"):
            pm = GPTLMHeadModel(GPTConfig(**GPT_KW))
            load_state(pm, state)
            got = pm.logits(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)

    def test_next_rng_tensor_is_fresh_each_call(self):
        with ht.graph("eager", create_new=True, device="cpu") as g:
            a, b = g.next_rng_tensor(), g.next_rng_tensor()
            assert a.shape == (2,) and a.dtype == torch.int32
            assert not torch.equal(a.get_data(), b.get_data())

    def test_default_graph_outside_a_block_is_eager_on_cuda(self,
                                                            monkeypatch):
        monkeypatch.setattr(pgraph, "_default_graphs", {})
        monkeypatch.setattr(pgraph, "_graph_stack", [])
        if torch.cuda.is_available():
            g = ht.get_default_graph()
            assert isinstance(g, ht.EagerGraph) and g.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                ht.get_default_graph()
        with ht.graph("eager", create_new=True, device="cpu") as g:
            assert ht.get_default_graph() is g

    @pytest.mark.parametrize("kind,cls", [
        ("eager", ht.EagerGraph), ("define_by_run", ht.DefineByRunGraph),
        ("define_and_run", ht.DefineAndRunGraph)])
    def test_graph_kinds(self, kind, cls):
        with ht.graph(kind, create_new=True, device="cpu") as g:
            assert type(g) is cls and g.device.type == "cpu"


# ---------------------------------------------------------------------------
# define-and-run: run levels and the plan pool
# ---------------------------------------------------------------------------

class TestDefineAndRun:
    def test_run_level_grad_then_update(self):
        """GRAD accumulates without updating; UPDATE applies."""
        X, Y = _data()
        out = {}
        for pkg in ("jax", "port"):
            m, nn, optim, ops, kw = PKGS[pkg]
            with m.graph("define_and_run", create_new=True, **kw) as g:
                x = m.placeholder("float32", (16, 8), name="x")
                y = m.placeholder("int32", (16,), name="y")
                w = m.parameter(np.full((4, 8), 0.1, np.float32), name="w")
                loss = ops.softmax_cross_entropy(
                    ops.matmul(x, w, trans_b=True), y)
                train_op = optim.SGDOptimizer(lr=0.1).minimize(loss)
                w0 = _np(g.get_tensor_value(w)).copy()
                g.run(loss, [loss, train_op], {x: X, y: Y}, run_level="grad")
                np.testing.assert_array_equal(w0, _np(g.get_tensor_value(w)))
                g.run(loss, [loss, train_op], {x: X, y: Y},
                      run_level="update")
                out[pkg] = _np(g.get_tensor_value(w))
                assert not np.allclose(w0, out[pkg])
        np.testing.assert_allclose(out["port"], out["jax"], rtol=0, atol=TOL)

    @pytest.mark.parametrize("micro", [1, 2])
    @pytest.mark.parametrize("opt", ["adam", "sgd"])
    def test_three_grad_runs_then_update_sum(self, opt, micro):
        """3 GRAD runs and an UPDATE on four batches: the update applies
        the sum of the four runs' gradients (each the mean over its
        micro-batches), as in the JAX package, and zeroes the sums."""
        batches = [_data(seed) for seed in range(5)]
        jg, jx, jy, jm, jloss, jop = _mlp_graph("jax", opt)
        state = _jax_state(jm)
        pg, px, py, pm, ploss, pop = _mlp_graph("port", opt, state)
        runs = {}
        for pkg, (g, x, y, m, loss, op) in (
                ("jax", (jg, jx, jy, jm, jloss, jop)),
                ("port", (pg, px, py, pm, ploss, pop))):
            losses = []
            before = _params(m)
            for i, (X, Y) in enumerate(batches[:4]):
                level = "grad" if i < 3 else "update"
                lv, u = g.run(loss, [loss, op], {x: X, y: Y},
                              num_micro_batches=micro, run_level=level)
                assert u is None
                losses.append(float(_np(lv)))
                if i < 3:
                    for k, v in _params(m).items():
                        np.testing.assert_array_equal(v, before[k])
            # the next update starts from zeroed sums
            X, Y = batches[4]
            g.run(loss, [loss, op], {x: X, y: Y}, num_micro_batches=micro)
            runs[pkg] = (losses, _params(m))
        np.testing.assert_allclose(runs["port"][0], runs["jax"][0],
                                   rtol=TOL)
        for k, v in runs["jax"][1].items():
            np.testing.assert_allclose(runs["port"][1][k], v, rtol=0,
                                       atol=TOL, err_msg=k)
        # the accumulator is zero again and each level kept its own plan
        assert all(float(a.abs().max()) == 0
                   for a in pg._grad_accum.values())
        assert len(pg._grad_accum) == len(pg.trainable_variables)

    def test_update_equals_one_step_on_the_summed_gradient(self):
        """GRAD x3 + UPDATE with SGD (no momentum) moves the weights by
        lr times the summed gradients of the four runs."""
        batches = [_data(seed) for seed in range(4)]
        jg, _, _, jm, _, _ = _mlp_graph("jax", "sgd")
        state = _jax_state(jm)
        with ht.graph("define_and_run", create_new=True, device="cpu") as g:
            x = ht.placeholder("float32", (16, 8), name="x")
            y = ht.placeholder("int32", (16,), name="y")
            model = pnn.Sequential(pnn.Linear(8, 16), pnn.ReLU(),
                                   pnn.Linear(16, 4))
            loss = pops.softmax_cross_entropy(model(x), y)
            xs = g.trainable_variables
            grads = ht.gradients(loss, xs)
            op = poptim.SGDOptimizer(lr=0.1).minimize(loss, var_list=xs)
            load_module_state(model, state)
        w0 = [_np(t.get_data()).copy() for t in xs]
        total = [np.zeros_like(w) for w in w0]
        for X, Y in batches:
            for a, gv in zip(total, g.run(grads, feed_dict={x: X, y: Y})):
                a += _np(gv)
        for i, (X, Y) in enumerate(batches):
            g.run(loss, [loss, op], {x: X, y: Y},
                  run_level="grad" if i < 3 else "update")
        for t, w, s in zip(xs, w0, total):
            np.testing.assert_allclose(_np(t.get_data()), w - 0.1 * s,
                                       rtol=0, atol=1e-6, err_msg=t.name)

    def test_ambient_run_level(self):
        X, Y = _data()
        g, x, y, m, loss, op = _mlp_graph("port", "sgd")
        before = _params(m)
        with ht.run_level("grad"):
            g.run(loss, [loss, op], {x: X, y: Y})
            g.run(loss, [loss, op], {x: X, y: Y})
        for k, v in _params(m).items():
            np.testing.assert_array_equal(v, before[k])
        assert {e.level for e in g._plan_pool.values()} == {ht.RunLevel.GRAD}
        g.run(loss, [loss, op], {x: X, y: Y})
        assert not np.allclose(_params(m)["0.weight"], before["0.weight"])

    def test_topo_returns_the_ops_in_order(self):
        orders = {}
        for pkg in ("jax", "port"):
            m, nn, optim, ops, kw = PKGS[pkg]
            with m.graph("define_and_run", create_new=True, **kw) as g:
                x = m.placeholder("float32", (4, 8), name="x")
                w = m.parameter(np.ones((8, 2), np.float32), name="w")
                out = ops.reduce_sum(ops.relu(ops.matmul(x, w)) * 2.0)
                order = g.run([out], run_level="topo")
                assert g.run([out], run_level=m.RunLevel.TOPO) == order
                assert len(g._plan_pool) == 0
            orders[pkg] = [n.op_type for n in order]
        assert orders["port"] == orders["jax"]
        assert orders["port"][-1] == "reduce_sum"

    def test_alloc_materializes_the_variables_only(self):
        for pkg in ("jax", "port"):
            m, nn, optim, ops, kw = PKGS[pkg]
            with m.graph("define_and_run", create_new=True, **kw) as g:
                x = m.placeholder("float32", (4, 8), name="x")
                lin = nn.Linear(8, 3)
                out = ops.reduce_sum(lin(x))
                assert not g._var_data
                assert g.run([out], run_level="alloc") == []
                assert set(g._var_data) == set(g._var_tensors)
                assert len(g._plan_pool) == 0
                assert lin.weight.numpy().shape == (3, 8)

    def test_plan_pool_caching(self):
        X, _ = _data(n=8)
        for pkg in ("jax", "port"):
            m, nn, optim, ops, kw = PKGS[pkg]
            batch = m.SymbolicDim("batch")
            with m.graph("define_and_run", create_new=True, **kw) as g:
                x = m.placeholder("float32", (batch, 8), name="x")
                w = m.parameter(np.eye(8, dtype=np.float32), name="w")
                out = ops.matmul(x, w)
                g.run([out], feed_dict={x: X})
                assert len(g._plan_pool) == 1
                g.run([out], feed_dict={x: X})
                assert len(g._plan_pool) == 1
                (v,) = g.run([out], feed_dict={x: X[:4]})
                assert len(g._plan_pool) == 2
                np.testing.assert_allclose(_np(v), X[:4], rtol=TOL)

    def test_feed_shape_mismatch_raises(self):
        for pkg in ("jax", "port"):
            m, nn, optim, ops, kw = PKGS[pkg]
            with m.graph("define_and_run", create_new=True, **kw) as g:
                x = m.placeholder("float32", (8, 4), name="x")
                out = ops.reduce_sum(x)
                with pytest.raises(ValueError, match="expected"):
                    g.run([out], feed_dict={x: np.ones((8, 5), np.float32)})

    def test_eval_then_train_plan_no_collision(self):
        X, Y = _data(n=32)
        for pkg in ("jax", "port"):
            m, nn, optim, ops, kw = PKGS[pkg]
            with m.graph("define_and_run", create_new=True, **kw) as g:
                x = m.placeholder("float32", (32, 8), name="x")
                y = m.placeholder("int32", (32,), name="y")
                w = m.parameter(np.full((4, 8), 0.1, np.float32), name="w")
                loss = ops.softmax_cross_entropy(
                    ops.matmul(x, w, trans_b=True), y)
                op = optim.SGDOptimizer(lr=0.5).minimize(loss)
                g.run([loss], feed_dict={x: X, y: Y})
                w0 = _np(g.get_tensor_value(w)).copy()
                g.run(loss, [loss, op], {x: X, y: Y})
                w1 = _np(g.get_tensor_value(w)).copy()
                assert not np.allclose(w0, w1), "train run did nothing"
                g.run([loss], feed_dict={x: X, y: Y})
                np.testing.assert_array_equal(w1,
                                              _np(g.get_tensor_value(w)))


# ---------------------------------------------------------------------------
# symbolic dims
# ---------------------------------------------------------------------------

class TestSymbolicDims:
    def test_symbolic_dim_arithmetic_dag(self):
        seq = ht.SymbolicDim("seq")
        cp = ht.SymbolicDim("cp", 4)
        local = seq // cp
        doubled = 2 * local + 1
        assert not local.is_bound and not doubled.is_bound
        seq.set(256)
        assert local.get() == 64 and doubled.get() == 129
        seq.set(512)
        assert local.get() == 128 and doubled.get() == 257
        assert (seq % 3).get() == 2 and (seq - 12).get() == 500
        assert (3 - ht.SymbolicDim("z", 1)).get() == 2
        e = ht.SymbolicDim("x") + 1
        assert not e.is_bound
        e.set(16)
        assert e.get() == 16 and e.is_bound
        e.clear_override()
        assert not e.is_bound
        with pytest.raises(ValueError, match="unbound"):
            e.get()
        assert "seq//cp" in local.name

    def test_tensor_shape_helpers(self):
        b = ht.SymbolicDim("b", 3)
        with ht.graph("define_and_run", create_new=True, device="cpu"):
            x = ht.placeholder("float32", (b, 4), name="x")
            y = ht.placeholder("float32", (2, 4), name="y")
        assert x.is_symbolic and not y.is_symbolic
        assert x.shape[0] is b and x.concrete_shape() == (3, 4)
        assert x.numel() == 12 and y.numel() == 8
        with pytest.raises(ValueError, match="static"):
            with ht.graph("define_and_run", create_new=True, device="cpu"):
                ht.parameter(ht.ConstantInitializer(0.0), (b, 4))

    def test_make_op_binds_an_unbound_dim_to_16(self):
        for m, ops, kw in ((jht, jops, {}), (ht, pops, CPU)):
            s = m.SymbolicDim("s")
            with m.graph("define_and_run", create_new=True, **kw):
                x = m.placeholder("float32", (2, s), name="x")
                assert x.shape[1] is s and not s.is_bound
                y = ops.reduce_sum(x, axis=0)
            assert s.get() == 16 and tuple(y.shape) == (16,)

    def test_symbolic_derived_in_placeholder_shape(self):
        for m, ops, kw in ((jht, jops, {}), (ht, pops, CPU)):
            seq = m.SymbolicDim("seq")
            with m.graph("define_and_run", create_new=True, **kw) as g:
                x = m.placeholder("float32", (2, seq, 4), name="x")
                y = m.placeholder("float32", (2, seq // 2, 4), name="y")
                out = ops.concat([x, y], axis=1)
                for s in (4, 8):
                    X = np.ones((2, s, 4), np.float32)
                    Y = np.ones((2, s // 2, 4), np.float32)
                    (val,) = g.run([out], feed_dict={x: X, y: Y})
                    assert _np(val).shape == (2, s + s // 2, 4)

    def test_symbolic_derived_feed_mismatch_raises(self):
        for m, ops, kw in ((jht, jops, {}), (ht, pops, CPU)):
            seq = m.SymbolicDim("seq")
            with m.graph("define_and_run", create_new=True, **kw) as g:
                x = m.placeholder("float32", (2, seq, 4), name="x")
                y = m.placeholder("float32", (2, seq // 2, 4), name="y")
                out = ops.concat([x, y], axis=1)
                with pytest.raises(ValueError, match="derived dim"):
                    g.run([out], feed_dict={
                        x: np.ones((2, 8, 4), np.float32),
                        y: np.ones((2, 3, 4), np.float32)})

    def test_symbolic_derived_leaf_not_fed(self):
        for m, ops, kw in ((jht, jops, {}), (ht, pops, CPU)):
            seq = m.SymbolicDim("seq")
            with m.graph("define_and_run", create_new=True, **kw) as g:
                x = m.placeholder("float32", (2, seq, 4), name="x")
                y = m.placeholder("float32", (2, seq // 2, 4), name="y")
                _ = ops.concat([x, y], axis=1)
                ysum = ops.reduce_sum(y)
                (val,) = g.run([ysum], feed_dict={
                    y: np.ones((2, 4, 4), np.float32)})
                assert float(_np(val)) == 32.0

    def test_symbolic_derived_with_shape_buckets(self):
        for m, ops, kw in ((jht, jops, {}), (ht, pops, CPU)):
            seq = m.SymbolicDim("seq")
            with m.graph("define_and_run", create_new=True, **kw) as g:
                x = m.placeholder("float32", (2, seq, 4), name="x")
                y = m.placeholder("float32", (2, seq // 2, 4), name="y")
                xs, ys = ops.reduce_sum(x), ops.reduce_sum(y)
                g.set_shape_buckets(4)
                xv, yv = g.run([xs, ys], feed_dict={
                    x: np.ones((2, 10, 4), np.float32),
                    y: np.ones((2, 5, 4), np.float32)})
                assert float(_np(xv)) == 80.0 and float(_np(yv)) == 40.0

    def test_symbolic_nested_derived_stale_intermediate(self):
        for m, ops, kw in ((jht, jops, {}), (ht, pops, CPU)):
            seq = m.SymbolicDim("seq")
            half = seq // 2
            quarter = half // 2
            with m.graph("define_and_run", create_new=True, **kw) as g:
                x = m.placeholder("float32", (2, seq, 4), name="x")
                y = m.placeholder("float32", (2, half, 4), name="y")
                z = m.placeholder("float32", (2, quarter, 4), name="z")
                _ = ops.reduce_sum(y)
                out = ops.concat([x, z], axis=1)
                (val,) = g.run([out], feed_dict={
                    x: np.ones((2, 64, 4), np.float32),
                    z: np.ones((2, 16, 4), np.float32)})
                assert _np(val).shape == (2, 80, 4)

    def test_symbolic_derived_conflicting_feeds_raise(self):
        for m, ops, kw in ((jht, jops, {}), (ht, pops, CPU)):
            half = m.SymbolicDim("seq") // 2
            with m.graph("define_and_run", create_new=True, **kw) as g:
                a = m.placeholder("float32", (half, 4), name="a")
                b = m.placeholder("float32", (half, 4), name="b")
                out = ops.add(a, b)
                with pytest.raises(ValueError, match="conflicting feeds"):
                    g.run([out], feed_dict={a: np.ones((3, 4), np.float32),
                                            b: np.ones((5, 4), np.float32)})

    def test_symbolic_seq_len(self):
        for m, ops, kw in ((jht, jops, {}), (ht, pops, CPU)):
            sym = m.SymbolicDim("seq")
            with m.graph("define_and_run", create_new=True, **kw) as g:
                x = m.placeholder("float32", (2, sym, 4), name="x")
                out = ops.reduce_sum(x, axis=1)
                for s in (3, 7):
                    (val,) = g.run([out], feed_dict={
                        x: np.ones((2, s, 4), np.float32)})
                    np.testing.assert_allclose(_np(val),
                                               np.full((2, 4), float(s)))
            assert len(g._plan_pool) == 2

    def test_derived_dim_override_cleared_across_runs(self):
        for m, kw in ((jht, {}), (ht, CPU)):
            seq = m.SymbolicDim("seq")
            half = seq // 2
            with m.graph("define_and_run", create_new=True, **kw) as g:
                a = m.placeholder("float32", (seq, 2), name="a")
                b = m.placeholder("float32", (half, 2), name="b")
                g._bind_symbolic_dims({b: np.zeros((8, 2), np.float32)})
                assert half.get() == 8
                g._bind_symbolic_dims({a: np.zeros((10, 2), np.float32)})
                assert seq.get() == 10 and half.get() == 5

    def test_gpt_symbolic_seq_raises_a_clear_value_error(self):
        """Both packages' GPT models bake the sequence length at build
        time: an unbound symbolic seq dim raises ``ValueError``."""
        for m, model, cfg, kw in (
                (jht, JaxGPTLMHeadModel, JaxGPTConfig, {}),
                (ht, GPTLMHeadModel, GPTConfig, CPU)):
            seq = m.SymbolicDim("seq")
            with m.graph("define_and_run", create_new=True, **kw):
                ids = m.placeholder("int32", (2, seq), name="ids")
                with pytest.raises(ValueError, match="'seq' is unbound"):
                    model(cfg(**GPT_KW))(ids, ids)

    def test_gpt_bound_symbolic_seq_computes_at_its_length_only(self):
        """A bound seq dim bakes its length: a feed of that length gives
        the JAX package's logits; another length raises (a ValueError
        naming the baked length in the port; JAX fails inside the run)."""
        ids = np.random.RandomState(2).randint(0, 97, (2, 16)).astype(
            np.int32)
        out = {}
        for pkg, (m, model, cfg, kw) in {
                "jax": (jht, JaxGPTLMHeadModel, JaxGPTConfig, {}),
                "port": (ht, GPTLMHeadModel, GPTConfig, CPU)}.items():
            seq = m.SymbolicDim("seq", 16)
            with m.graph("define_and_run", create_new=True, **kw) as g:
                ph = m.placeholder("int32", (2, seq), name="ids")
                mdl = model(cfg(**GPT_KW))
                logits = mdl.logits(ph)
                if pkg == "port":
                    load_state(mdl, out["state"])
                else:
                    g.run([], run_level="alloc")
                    out["state"] = _jax_state(mdl)
                (out[pkg],) = g.run([logits], feed_dict={ph: ids})
                longer = np.concatenate([ids, ids], axis=1)
                with pytest.raises((ValueError, TypeError)) as err:
                    g.run([logits], feed_dict={ph: longer})
                if pkg == "port":
                    assert err.type is ValueError
                    assert "seq = 16" in str(err.value)
                    assert "JAX package" in str(err.value)
        np.testing.assert_allclose(_np(out["port"]), _np(out["jax"]),
                                   rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# define-by-run graphs
# ---------------------------------------------------------------------------

class TestDefineByRunGraph:
    def test_get_or_compute_lazy_and_cached(self):
        for m, kw in ((jht, {}), (ht, CPU)):
            with m.graph("define_by_run", create_new=True, **kw) as g:
                w = m.parameter(m.ConstantInitializer(2.0), (3,), name="w")
                y = w * 3.0
                z = y + 1.0
                assert y.id not in g._computed
                np.testing.assert_allclose(_np(g.get_or_compute(z)),
                                           [7.0] * 3)
                zz = z * 2.0
                np.testing.assert_allclose(_np(g.get_or_compute(zz)),
                                           [14.0] * 3)
                assert z.id in g._computed and y.id in g._computed
                assert w.id not in g._computed

    def test_feed_and_invalidate(self):
        for m, kw in ((jht, {}), (ht, CPU)):
            with m.graph("define_by_run", create_new=True, **kw) as g:
                x = m.placeholder("float32", (2,), name="x")
                y = x * 10.0
                g.feed(x, np.array([1.0, 2.0], np.float32))
                np.testing.assert_allclose(_np(g.get_or_compute(y)),
                                           [10.0, 20.0])
                g.invalidate()
                g.feed(x, np.array([3.0, 4.0], np.float32))
                np.testing.assert_allclose(_np(g.get_or_compute(y)),
                                           [30.0, 40.0])

    def test_variable_updates_reach_later_fetches(self):
        with ht.graph("define_by_run", create_new=True, device="cpu") as g:
            w = ht.parameter(ht.ConstantInitializer(1.0), (2,), name="w")
            y = w * 2.0
            np.testing.assert_allclose(_np(g.get_or_compute(y)), [2.0, 2.0])
            g.reset_variable(w, np.array([3.0, 4.0], np.float32))
            g.invalidate()
            np.testing.assert_allclose(_np(g.get_or_compute(y)), [6.0, 8.0])

    def test_gpt_logits_then_loss_reuses_the_forward(self):
        """``get_or_compute(logits)`` then ``get_or_compute(loss)`` of a
        loss built on those logits: the second runs only the loss ops,
        and both equal the JAX package's define-by-run values."""
        rng = np.random.RandomState(3)
        x = rng.randint(0, 97, (2, 16)).astype(np.int32)
        y = rng.randint(0, 97, (2, 16)).astype(np.int32)
        out = {}
        for pkg, (m, model, cfg, nn, kw) in {
                "jax": (jht, JaxGPTLMHeadModel, JaxGPTConfig, jnn, {}),
                "port": (ht, GPTLMHeadModel, GPTConfig, pnn, CPU)}.items():
            with m.graph("define_by_run", create_new=True, **kw) as g:
                ids = m.placeholder("int32", (2, 16), name="ids")
                lab = m.placeholder("int32", (2, 16), name="lab")
                mdl = model(cfg(**GPT_KW))
                logits = mdl.logits(ids)
                loss = nn.vocab_parallel_cross_entropy(logits, lab,
                                                       ignore_index=-100)
                if pkg == "port":
                    load_state(mdl, out["state"])
                else:
                    out["state"] = _jax_state(mdl)
                g.feed(ids, x)
                g.feed(lab, y)
                lv = g.get_or_compute(logits)
                n = len(g._computed)
                loss_v = g.get_or_compute(loss)
                assert g._computed[logits.id] is lv
                assert len(g._computed) > n
                out[pkg] = (_np(lv), float(_np(loss_v)))
        np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(out["port"][1], out["jax"][1], rtol=TOL)


# ---------------------------------------------------------------------------
# shape buckets
# ---------------------------------------------------------------------------

class TestShapeBuckets:
    def test_20_random_lens_trigger_few_compiles(self):
        out = {}
        for pkg in ("jax", "port"):
            m, nn, optim, ops, kw = PKGS[pkg]
            rng = np.random.RandomState(0)
            seq = m.SymbolicDim("seq")
            with m.graph("define_and_run", create_new=True, **kw) as g:
                x = m.placeholder("float32", (2, seq, 8), name="x")
                y = m.placeholder("int32", (2, seq), name="y")
                w = m.parameter(np.full((4, 8), 0.1, np.float32), name="w")
                loss = ops.softmax_cross_entropy(
                    ops.matmul(x, w, trans_b=True), y, ignore_index=-100)
                g.set_shape_buckets([32, 64, 96, 128], pad_values={y: -100})
                losses = {}
                for _ in range(20):
                    s = int(rng.randint(5, 129))
                    X = rng.randn(2, s, 8).astype(np.float32)
                    Y = (np.arange(2 * s).reshape(2, s) % 4).astype(np.int32)
                    (lv,) = g.run([loss], feed_dict={x: X, y: Y})
                    losses[s] = (float(_np(lv)), X, Y)
                assert len(g._plan_pool) <= 4
            out[pkg] = losses
        for s, (lv, X, Y) in out["port"].items():
            z = X @ np.full((4, 8), 0.1, np.float32).T
            lp = z - np.log(np.sum(np.exp(z), -1, keepdims=True))
            ref = float(np.mean(-np.take_along_axis(lp, Y[..., None], -1)))
            np.testing.assert_allclose(lv, ref, rtol=1e-5, err_msg=str(s))
            np.testing.assert_allclose(lv, out["jax"][s][0], rtol=TOL)

    def test_alignment_buckets_and_overflow(self):
        for m, ops, kw in ((jht, jops, {}), (ht, pops, CPU)):
            seq = m.SymbolicDim("seq")
            with m.graph("define_and_run", create_new=True, **kw) as g:
                x = m.placeholder("float32", (1, seq), name="x")
                out = ops.reduce_sum(x)
                g.set_shape_buckets(16)
                for s in (3, 9, 16, 17, 30):
                    (v,) = g.run([out], feed_dict={
                        x: np.ones((1, s), np.float32)})
                    assert float(_np(v)) == s
                assert len(g._plan_pool) == 2
            with m.graph("define_and_run", create_new=True, **kw) as g:
                x = m.placeholder("float32", (1, seq), name="x")
                out = ops.reduce_sum(x)
                g.set_shape_buckets([8])
                with pytest.raises(ValueError, match="exceeds"):
                    g.run([out], feed_dict={x: np.ones((1, 9), np.float32)})
        with ht.graph("define_and_run", create_new=True, device="cpu") as g:
            with pytest.raises(ValueError, match="non-empty"):
                g.set_shape_buckets([])

    def test_torch_feeds_pad_as_numpy_feeds(self):
        seq = ht.SymbolicDim("seq")
        with ht.graph("define_and_run", create_new=True, device="cpu") as g:
            x = ht.placeholder("int32", (2, seq), name="x")
            out = pops.reduce_sum(pops.cast(x, "float32"))
            g.set_shape_buckets([8], pad_values={x: -1})
            X = np.ones((2, 5), np.int32)
            (a,) = g.run([out], feed_dict={x: X})
            (b,) = g.run([out], feed_dict={x: torch.from_numpy(X)})
        assert float(a) == float(b) == 10.0 - 6.0
        assert len(g._plan_pool) == 1   # one plan for both kinds of feed

    @pytest.mark.parametrize("micro", [1, 2])
    def test_symbolic_batch_gpt_on_buckets_as_jax(self, micro):
        """GPT training on a symbolic batch dim with buckets [4, 8] and
        label pad -100, batches 3, 8, 5 and 1: two plans, and the losses
        and weights of the JAX package's run.  With two micro-batches a
        batch of 5 pads to 8 and the pad rows fill the last micro-batch,
        whose mean stands as it is in both packages."""
        rng = np.random.RandomState(4)
        sizes = (3, 8, 5, 1)
        data = [rng.randint(0, 97, (b, 17)).astype(np.int32) for b in sizes]
        runs = {}
        for pkg, (m, model, cfg, optim, kw) in {
                "jax": (jht, JaxGPTLMHeadModel, JaxGPTConfig, joptim, {}),
                "port": (ht, GPTLMHeadModel, GPTConfig, poptim,
                         CPU)}.items():
            batch = m.SymbolicDim("batch")
            with m.graph("define_and_run", create_new=True, **kw) as g:
                ids = m.placeholder("int32", (batch, 16), name="ids")
                lab = m.placeholder("int32", (batch, 16), name="lab")
                mdl = model(cfg(**GPT_KW))
                loss = mdl(ids, lab)
                op = optim.SGDOptimizer(lr=0.5).minimize(loss)
                g.set_shape_buckets([4, 8], pad_values={lab: -100})
                if pkg == "port":
                    load_state(mdl, runs["state"])
                else:
                    g.run([], run_level="alloc")
                    runs["state"] = _jax_state(mdl)
            losses = []
            for toks in data:
                lv, _ = g.run(loss, [loss, op],
                              {ids: toks[:, :-1], lab: toks[:, 1:]},
                              num_micro_batches=micro)
                losses.append(float(_np(lv)))
            assert len(g._plan_pool) == 2
            runs[pkg] = (losses, _params(mdl))
        np.testing.assert_allclose(runs["port"][0], runs["jax"][0],
                                   rtol=TOL)
        for k, v in runs["jax"][1].items():
            np.testing.assert_allclose(runs["port"][1][k], v, rtol=0,
                                       atol=TOL, err_msg=k)

    def test_padded_step_equals_the_exact_size_step(self):
        """At one micro-batch a batch of 3 padded to 4 (labels -100)
        gives the loss and the update of the same 3 rows unpadded."""
        toks = np.random.RandomState(5).randint(0, 97, (3, 17)).astype(
            np.int32)
        out = []
        for buckets in ([4], None):
            ht.set_seed(11)
            batch = ht.SymbolicDim("batch")
            with ht.graph("define_and_run", create_new=True,
                          device="cpu") as g:
                ids = ht.placeholder("int32", (batch, 16), name="ids")
                lab = ht.placeholder("int32", (batch, 16), name="lab")
                mdl = GPTLMHeadModel(GPTConfig(**GPT_KW))
                loss = mdl(ids, lab)
                op = poptim.AdamOptimizer(lr=1e-3).minimize(loss)
                if buckets:
                    g.set_shape_buckets(buckets, pad_values={lab: -100})
            lv, _ = g.run(loss, [loss, op], {ids: toks[:, :-1],
                                             lab: toks[:, 1:]})
            (key,) = g._plan_pool
            assert dict((tid, s) for tid, s in key[1])[ids.id] == (
                (4 if buckets else 3), 16)
            out.append((float(lv), _params(mdl)))
        np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
        for k, v in out[1][1].items():
            np.testing.assert_allclose(out[0][1][k], v, rtol=0, atol=1e-6,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# seeds
# ---------------------------------------------------------------------------

def test_set_seed_reproducible_init():
    def build(seed):
        ht.set_seed(seed)
        with ht.graph("define_and_run", create_new=True, device="cpu") as g:
            w = ht.parameter(ht.NormalInitializer(stddev=1.0), (8, 8),
                             name="w")
            v = ht.parameter(ht.XavierUniformInitializer(), (4, 8), name="v")
        # materialized in the reverse of creation order: the weights
        # still follow creation order
        return g._materialize_var(v).clone(), g._materialize_var(w).clone()

    a, b, c = build(123), build(123), build(124)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    with jht.graph("define_and_run", create_new=True):
        jht.set_seed(123)
        jw = jht.parameter(jht.NormalInitializer(stddev=1.0), (8, 8))
    # the same invariants, not the same bits: jax draws by threefry
    assert np.asarray(jw.numpy()).shape == tuple(a[1].shape)


def test_set_seed_dropout_stream_decoupled_from_numpy():
    def seed_of():
        with ht.graph("define_and_run", create_new=True, device="cpu") as g:
            return g._rng_seed

    ht.set_seed(5)
    a = seed_of()
    np.random.seed(999)
    np.random.rand(10)
    ht.set_seed(5)
    b = seed_of()
    assert a == b
    np.random.seed(42)
    u1 = np.random.rand()
    np.random.seed(42)
    ht.set_seed(7)
    u2 = np.random.rand()
    assert u1 == u2


def test_set_seed_gives_equal_dropout_masks():
    masks = []
    for _ in range(2):
        ht.set_seed(9)
        with ht.graph("define_and_run", create_new=True, device="cpu") as g:
            x = ht.placeholder("float32", (4, 64), name="x")
            d = pops.dropout(x, 0.5, training=True)
        (v,) = g.run([d], feed_dict={x: np.ones((4, 64), np.float32)})
        masks.append(v)
    assert torch.equal(masks[0], masks[1])


def test_explicit_seeds_keep_their_own_streams():
    """A graph's ``seed`` and an initializer's ``seed`` win over the
    process-wide streams, whatever ``set_seed`` said."""
    vals = []
    for s in (1, 2):
        ht.set_seed(s)
        with ht.graph("define_and_run", create_new=True, device="cpu",
                      seed=0) as g:
            w = ht.parameter(ht.NormalInitializer(), (4,), name="w")
            u = ht.parameter(ht.NormalInitializer(seed=3), (4,), name="u")
        vals.append((w.numpy(), u.numpy(), g._rng_seed))
    np.testing.assert_array_equal(vals[0][0], vals[1][0])
    np.testing.assert_array_equal(vals[0][1], vals[1][1])
    assert vals[0][2] == vals[1][2] == 0


# ---------------------------------------------------------------------------
# data types and devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [d.value for d in jdtype.DataType])
def test_data_types_as_jax(name):
    j, p = jdtype.DataType(name), ht.DataType(name)
    assert p.is_floating_point == j.is_floating_point
    assert p.is_quantized == j.is_quantized
    assert p.itemsize == j.itemsize
    attr = "bool_" if name == "bool" else name
    assert getattr(ht, attr, None) is (p if hasattr(jht, attr) else None)
    want = np.dtype(j.to_jnp()).name
    got = str(p.to_torch()).replace("torch.", "")
    assert got == want, (got, want)


def test_canonicalize_dtype_aliases():
    pd = importlib.import_module("hetu_tpu_torch.core.dtype")
    for alias in ("fp16", "bf16", "half", "float", "double", "fp4", "nf4",
                  "int", "long"):
        assert pd.canonicalize_dtype(alias).value == \
            jdtype.canonicalize_dtype(alias).value
    assert pd.canonicalize_dtype(np.float16) is ht.float16
    assert pd.canonicalize_dtype(torch.bfloat16) is ht.bfloat16
    assert pd.torch_dtype(ht.int64) is torch.int32
    with pytest.raises(ValueError, match="unknown dtype"):
        pd.canonicalize_dtype("float8")


def test_devices_as_jax():
    pdev = importlib.import_module("hetu_tpu_torch.core.device")
    for spec in ("cpu", "cuda:3", "host1/cuda:0"):
        d = ht.Device.parse(spec)
        j = jdevice.Device.parse(spec.replace("cuda", "tpu"))
        assert (d.index, d.hostname, d.local()) == \
            (j.index, j.hostname, j.local())
        assert str(d) == str(j).replace("tpu", "cuda")
    assert ht.Device.parse("cuda:1").is_cuda
    grp = ht.DeviceGroup(["cuda:0", "cuda:1", "cuda:1"])
    assert grp.num_devices == 3 and grp.get_index("cuda:1") == 1
    assert grp.contains("cuda:0") and not grp.contains("cuda:2")
    uni = ht.DeviceGroupUnion([grp, ht.DeviceGroup(["cuda:2", "cuda:0"])])
    assert [str(d) for d in uni.all_devices()] == ["cuda:0", "cuda:1",
                                                   "cuda:2"]
    assert pdev.resolve_device(ht.Device.parse("cpu")).type == "cpu"
    local, every = pdev.local_device(), pdev.global_device_group()
    assert every.contains(local)
    if not torch.cuda.is_available():
        assert local.is_cpu and every.num_devices == 1
    else:
        assert every.num_devices == torch.cuda.device_count()
