"""The port's op library against the JAX package's, on the CPU.

Every op of ``hetu_tpu.ops.functional`` that the port has is run in both
packages on the same seeded numpy inputs, each inside a define-and-run
graph whose floating inputs are variables: the op's outputs and the
gradients of ``sum(out * w)`` (``w`` fixed random weights) for every
variable input.  fp32 throughout; forward and gradients within
``TOL`` = 1e-5 (both sides run the same formulas, in other summation
orders).  The ops where torch's own function disagrees with JAX
(``gelu``'s default, the biased batch variance, average pools over the
non-padding elements, -inf max-pool padding, the ignored-label mean,
``binary_cross_entropy``'s eps, ``kl_div``'s mean, ``one_hot`` out of
range, ``split``'s even division, ``as_strided`` past the storage,
``topk``) have cases of their own, which also show torch's answer to be
different.
"""
import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import hetu_tpu as jht
import hetu_tpu_torch as ht
from hetu_tpu_torch.ops import functional as pops

jops = importlib.import_module("hetu_tpu.ops.functional")

TOL = 1e-5


def _rng(seed):
    return np.random.RandomState(seed)


def _f32(*shape, seed=0, lo=None, hi=None):
    r = _rng(seed)
    if lo is None:
        return r.randn(*shape).astype(np.float32)
    return r.uniform(lo, hi, shape).astype(np.float32)


def _positive(*shape, seed=0):
    return _f32(*shape, seed=seed, lo=0.5, hi=2.0)


def _distinct(*shape, seed=0):
    """Values with no ties (topk, argmax, max pools)."""
    n = int(np.prod(shape))
    return (_rng(seed).permutation(n).reshape(shape) / n - 0.5) \
        .astype(np.float32)


# name -> (fn(ops, *inputs), inputs, indices of the variable inputs); the
# other inputs are fed placeholders (bool ones numpy constants)
CASES = {
    "sub": (lambda o, a, b: o.sub(a, b), [_f32(3, 4), _f32(4, seed=1)],
            (0, 1)),
    "div": (lambda o, a, b: o.div(a, b), [_f32(3, 4), _positive(3, 4)],
            (0, 1)),
    "neg": (lambda o, a: o.neg(a), [_f32(3, 4)], (0,)),
    "reciprocal": (lambda o, a: o.reciprocal(a), [_positive(3, 4)], (0,)),
    "abs": (lambda o, a: o.abs(a), [_f32(3, 4)], (0,)),
    "exp": (lambda o, a: o.exp(a), [_f32(3, 4)], (0,)),
    "log": (lambda o, a: o.log(a), [_positive(3, 4)], (0,)),
    "sqrt": (lambda o, a: o.sqrt(a), [_positive(3, 4)], (0,)),
    "rsqrt": (lambda o, a: o.rsqrt(a), [_positive(3, 4)], (0,)),
    "ceil": (lambda o, a: o.ceil(a), [_f32(3, 4) * 3], (0,)),
    "floor": (lambda o, a: o.floor(a), [_f32(3, 4) * 3], (0,)),
    "round": (lambda o, a: o.round(a),
              [np.array([[0.5, 1.5, 2.5, -0.5], [-1.5, 0.4, 2.6, -2.5]],
                        np.float32)], (0,)),
    "sin": (lambda o, a: o.sin(a), [_f32(3, 4)], (0,)),
    "cos": (lambda o, a: o.cos(a), [_f32(3, 4)], (0,)),
    "tanh": (lambda o, a: o.tanh(a), [_f32(3, 4)], (0,)),
    "sigmoid": (lambda o, a: o.sigmoid(a), [_f32(3, 4)], (0,)),
    "maximum": (lambda o, a, b: o.maximum(a, b),
                [_f32(3, 4), _f32(3, 4, seed=1)], (0, 1)),
    "minimum": (lambda o, a, b: o.minimum(a, b),
                [_f32(3, 4), _f32(3, 4, seed=1)], (0, 1)),
    "maximum_scalar": (lambda o, a: o.maximum(a, 0.25), [_f32(3, 4)], (0,)),
    "pow": (lambda o, a: o.pow(a, 3.0), [_f32(3, 4)], (0,)),
    "clamp": (lambda o, a: o.clamp(a, -0.5, 0.7), [_f32(3, 4)], (0,)),
    "clamp_max_only": (lambda o, a: o.clamp(a, max=0.2), [_f32(3, 4)], (0,)),
    "where": (lambda o, c, a, b: o.where(c, a, b),
              [_f32(3, 4, seed=2) > 0, _f32(3, 4), _f32(3, 4, seed=1)],
              (1, 2)),
    "cast_bf16": (lambda o, a: o.cast(o.cast(a, "bfloat16"), "float32"),
                  [_f32(3, 4)], (0,)),
    "cast_int32": (lambda o, a: o.cast(a, "int32"), [_f32(3, 4) * 5], ()),
    "relu": (lambda o, a: o.relu(a), [_f32(3, 4)], (0,)),
    "leaky_relu": (lambda o, a: o.leaky_relu(a, 0.2), [_f32(3, 4)], (0,)),
    "silu": (lambda o, a: o.silu(a), [_f32(3, 4)], (0,)),
    "swish": (lambda o, a: o.swish(a), [_f32(3, 4)], (0,)),
    "elu": (lambda o, a: o.elu(a), [_f32(3, 4)], (0,)),
    "softplus": (lambda o, a: o.softplus(a), [_f32(3, 4) * 10], (0,)),
    "gelu_exact": (lambda o, a: o.gelu(a, approximate=False), [_f32(3, 4)],
                   (0,)),
    "einsum": (lambda o, a, b: o.einsum("bij,bjk->bik", a, b),
               [_f32(2, 3, 4), _f32(2, 4, 5, seed=1)], (0, 1)),
    "batch_matmul": (lambda o, a, b: o.batch_matmul(a, b, trans_b=True),
                     [_f32(2, 3, 4), _f32(2, 5, 4, seed=1)], (0, 1)),
    "reduce_mean": (lambda o, a: o.reduce_mean(a, axis=(0, 2)),
                    [_f32(2, 3, 4)], (0,)),
    "reduce_mean_all_keepdims": (
        lambda o, a: o.reduce_mean(a, keepdims=True), [_f32(2, 3, 4)], (0,)),
    "reduce_sum_keepdims": (lambda o, a: o.reduce_sum(a, 1, keepdims=True),
                            [_f32(2, 3, 4)], (0,)),
    "reduce_max": (lambda o, a: o.reduce_max(a, axis=1),
                   [_distinct(2, 3, 4)], (0,)),
    "reduce_min": (lambda o, a: o.reduce_min(a, axis=[0, 2], keepdims=True),
                   [_distinct(2, 3, 4)], (0,)),
    "argmax": (lambda o, a: o.argmax(a, axis=1), [_distinct(3, 5)], ()),
    "cumsum": (lambda o, a: o.cumsum(a, axis=1), [_f32(3, 5)], (0,)),
    "cumsum_int": (lambda o, a: o.cumsum(a, axis=0),
                   [_rng(0).randint(0, 9, (4, 3)).astype(np.int32)], ()),
    "topk": (lambda o, a: o.topk(a, 3), [_distinct(4, 6)], (0,)),
    "topk_axis0": (lambda o, a: o.topk(a, 2, axis=0), [_distinct(5, 3)],
                   (0,)),
    "transpose": (lambda o, a: o.transpose(a, (2, 0, 1)), [_f32(2, 3, 4)],
                  (0,)),
    "transpose_reverse": (lambda o, a: o.transpose(a), [_f32(2, 3, 4)],
                          (0,)),
    "slice": (lambda o, a: o.slice(a, (1, 0, 2), (2, 3, 2)), [_f32(3, 3, 4)],
              (0,)),
    "as_strided": (lambda o, a: o.as_strided(a, (4, 3), (2, 1), 1),
                   [_f32(3, 4)], (0,)),
    "as_strided_negative": (lambda o, a: o.as_strided(a, (3, 2), (-4, 1), 9),
                            [_f32(3, 4)], (0,)),
    "split": (lambda o, a: o.split(a, 3, axis=1), [_f32(2, 6)], (0,)),
    "concat": (lambda o, a, b: o.concat([a, b], axis=1),
               [_f32(2, 3), _f32(2, 2, seed=1)], (0, 1)),
    "concatenate": (lambda o, a, b: o.concatenate([a, b], axis=0),
                    [_f32(2, 3), _f32(1, 3, seed=1)], (0, 1)),
    "stack": (lambda o, a, b: o.stack([a, b], axis=1),
              [_f32(2, 3), _f32(2, 3, seed=1)], (0, 1)),
    "pad": (lambda o, a: o.pad(a, ((1, 0), (2, 3)), value=0.5),
            [_f32(2, 3)], (0,)),
    "broadcast_to": (lambda o, a: o.broadcast_to(a, (2, 3, 4)),
                     [_f32(3, 1)], (0,)),
    "triu": (lambda o, a: o.triu(a, 1), [_f32(2, 4, 4)], (0,)),
    "tril": (lambda o, a: o.tril(a, -1), [_f32(4, 5)], (0,)),
    "gather": (lambda o, a, i: o.gather(a, i, axis=1),
               [_f32(3, 5), np.array([[0, 4], [2, 2], [1, 3]], np.int32)],
               (0,)),
    "index_select": (lambda o, a, i: o.index_select(a, i, axis=1),
                     [_f32(3, 5, 2), np.array([[4, 0], [1, 1]], np.int32)],
                     (0,)),
    "one_hot": (lambda o, i: o.one_hot(i, 5, "float32"),
                [np.array([[0, 4], [2, 3]], np.int32)], ()),
    "softmax": (lambda o, a: o.softmax(a, axis=0), [_f32(3, 5)], (0,)),
    "log_softmax": (lambda o, a: o.log_softmax(a), [_f32(3, 5)], (0,)),
    "nll_loss": (lambda o, a, t: o.nll_loss(o.log_softmax(a), t),
                 [_f32(4, 5), np.array([0, 3, 4, 1], np.int32)], (0,)),
    "nll_loss_none": (lambda o, a, t: o.nll_loss(a, t, reduction="none"),
                      [_f32(2, 3, 5), np.array([[0, 3, 4], [1, 1, 2]],
                                               np.int32)], (0,)),
    "sparse_softmax_cross_entropy": (
        lambda o, a, t: o.sparse_softmax_cross_entropy(a, t, "sum"),
        [_f32(4, 5), np.array([0, 3, 4, 1], np.int32)], (0,)),
    "softmax_cross_entropy_dense": (
        lambda o, a, t: o.softmax_cross_entropy(a, t),
        [_f32(4, 5), _positive(4, 5, seed=3) / 6], (0, 1)),
    "mse_loss": (lambda o, a, b: o.mse_loss(a, b),
                 [_f32(3, 4), _f32(3, 4, seed=1)], (0, 1)),
    "bce_with_logits": (
        lambda o, a, t: o.binary_cross_entropy(a, t, with_logits=True),
        [_f32(6) * 4, (_f32(6, seed=1) > 0).astype(np.float32)], (0,)),
    "bce_probs": (lambda o, p, t: o.binary_cross_entropy(p, t, "sum"),
                  [_f32(6, lo=0.05, hi=0.95),
                   (_f32(6, seed=1) > 0).astype(np.float32)], (0,)),
    "kl_div_sum": (lambda o, lp, t: o.kl_div(lp, t, "sum"),
                   [np.log(_positive(3, 4) / 8), _positive(3, 4, seed=1) / 8],
                   (0, 1)),
    "batch_norm_eval": (
        lambda o, x, s, b, rm, rv: o.batch_norm(x, s, b, rm, rv,
                                                training=False),
        [_f32(4, 3, 5, 5), _positive(3), _f32(3, seed=1),
         _f32(3, seed=2), _positive(3, seed=3)], (0, 1, 2)),
    "batch_norm_nc": (lambda o, x, s, b: o.batch_norm(x, s, b),
                      [_f32(8, 3), _positive(3), _f32(3, seed=1)],
                      (0, 1, 2)),
    "batch_norm_stats": (lambda o, x: o.batch_norm_stats(x),
                         [_f32(4, 3, 5, 5) * 2 + 1], (0,)),
    "instance_norm": (lambda o, x: o.instance_norm(x), [_f32(2, 3, 5, 5)],
                      (0,)),
    "conv2d": (lambda o, x, w, b: o.conv2d(x, w, b, stride=2, padding=1),
               [_f32(2, 3, 9, 9), _f32(4, 3, 3, 3, seed=1) / 3,
                _f32(4, seed=2)], (0, 1, 2)),
    "conv2d_asymmetric_padding": (
        lambda o, x, w: o.conv2d(x, w, None, stride=(1, 2),
                                 padding=((1, 0), (2, 1))),
        [_f32(2, 3, 7, 8), _f32(4, 3, 3, 2, seed=1) / 3], (0, 1)),
    "max_pool": (lambda o, x: o.max_pool(x, 3, 2), [_distinct(2, 3, 9, 9)],
                 (0,)),
    "avg_pool": (lambda o, x: o.avg_pool(x, (2, 3), (2, 1)),
                 [_f32(2, 3, 8, 9)], (0,)),
}


def _graph_run(pkg, o, fn, arrays, diff, device):
    """``fn``'s outputs and the gradients of sum(out * w) over the
    variable inputs, through one define-and-run graph of ``pkg``."""
    kw = {} if pkg is jht else {"device": device}
    with pkg.graph("define_and_run", create_new=True, **kw) as g:
        ins, feeds = [], {}
        for i, a in enumerate(arrays):
            if i in diff:
                ins.append(pkg.parameter(a, name=f"x{i}"))
            elif a.dtype == np.bool_:
                ins.append(a)                 # a constant of the graph
            else:
                ins.append(pkg.placeholder(str(a.dtype), a.shape))
                feeds[ins[-1]] = a
        outs = fn(o, *ins)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        fetch = list(outs)
        if diff:
            rng = _rng(7)
            loss = None
            for y in outs:
                if "int" in str(y.dtype):
                    continue
                term = o.reduce_sum(
                    o.mul(y, np.asarray(rng.randn(*y.shape), np.float32)))
                loss = term if loss is None else o.add(loss, term)
            fetch += g.make_gradients(loss, [ins[i] for i in diff])
        vals = g.run(fetch, feed_dict=feeds)
    return [np.asarray(v.float() if isinstance(v, torch.Tensor) and
                       v.is_floating_point() else v) for v in vals]


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_and_gradient_match_jax(name):
    fn, arrays, diff = CASES[name]
    want = _graph_run(jht, jops, fn, arrays, diff, None)
    got = _graph_run(ht, pops, fn, arrays, diff, "cpu")
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        assert a.dtype == b.dtype or (a.dtype.kind == b.dtype.kind == "f"), \
            (i, a.dtype, b.dtype)
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                   err_msg=f"{name} output {i}")


EAGER_CASES = ["sub", "div", "maximum_scalar", "einsum", "reduce_mean",
               "topk", "split", "gather", "softmax", "conv2d", "max_pool",
               "batch_norm_stats"]


@pytest.mark.parametrize("name", EAGER_CASES)
def test_eager_ops_on_torch_tensors_equal_the_graph(name):
    """Without a graph an op runs at once on torch tensors (the numpy
    inputs becoming tensors too) and gives the graph's values."""
    fn, arrays, diff = CASES[name]
    graph_vals = _graph_run(ht, pops, fn, arrays, (), "cpu")
    outs = fn(pops, *[torch.from_numpy(a) if i in diff else a
                      for i, a in enumerate(arrays)])
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    assert all(isinstance(v, torch.Tensor) for v in outs)
    for a, b in zip(outs, graph_vals):
        np.testing.assert_array_equal(a.numpy(), b)


# ---------------------------------------------------------------------------
# where torch's own function disagrees with JAX, the port follows JAX
# ---------------------------------------------------------------------------

def _both(fn, *arrays):
    """``fn`` in both packages' eager paths: (port, JAX) as numpy."""
    got = fn(pops, *[torch.from_numpy(np.asarray(a)) for a in arrays])
    want = fn(jops, *arrays)
    return np.asarray(got), np.asarray(want.numpy())


def test_gelu_defaults_to_the_tanh_approximation():
    x = _f32(64) * 3
    got, want = _both(lambda o, a: o.gelu(a), x)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    exact = F.gelu(torch.from_numpy(x)).numpy()        # torch's default
    assert np.abs(got - exact).max() > 1e-4


def test_batch_norm_uses_the_biased_variance():
    x = _f32(4, 3, 5, 5) * 2 + 1
    s, b = np.ones(3, np.float32), np.zeros(3, np.float32)
    got, want = _both(lambda o, *a: o.batch_norm(*a), x, s, b)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    gm, gv = [t.numpy() for t in pops.batch_norm_stats(torch.from_numpy(x))]
    jm, jv = [np.asarray(t.numpy()) for t in jops.batch_norm_stats(x)]
    np.testing.assert_allclose(gm, jm, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gv, jv, rtol=TOL)
    np.testing.assert_allclose(gv, x.var(axis=(0, 2, 3)), rtol=1e-5)
    unbiased = torch.from_numpy(x).var(dim=(0, 2, 3)).numpy()
    assert np.abs(gv - unbiased).min() > 1e-3


def test_avg_pool_counts_only_the_non_padding_elements():
    x = _f32(2, 3, 6, 6)
    got, want = _both(lambda o, a: o.avg_pool(a, 3, 2, 1), x)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, F.avg_pool2d(
        torch.from_numpy(x), 3, 2, 1, count_include_pad=False).numpy(),
        rtol=TOL, atol=TOL)
    included = F.avg_pool2d(torch.from_numpy(x), 3, 2, 1).numpy()
    assert np.abs(got - included).max() > 1e-3


def test_max_pool_pads_with_minus_infinity():
    x = -_positive(1, 2, 5, 5)               # every value below 0
    got, want = _both(lambda o, a: o.max_pool(a, 3, 2, 1), x)
    np.testing.assert_array_equal(got, want)
    assert (got < 0).all()                   # a 0 pad would win the corners
    zero_padded = F.max_pool2d(F.pad(torch.from_numpy(x), (1, 1, 1, 1)),
                               3, 2).numpy()
    assert (zero_padded == 0).any()


def test_cross_entropy_ignored_labels_and_dense_targets():
    lg = _f32(6, 5)
    t = np.array([1, -100, 3, -100, 0, 4], np.int32)
    got, want = _both(lambda o, a, b: o.softmax_cross_entropy(
        a, b, ignore_index=-100), lg, t)
    np.testing.assert_allclose(got, want, rtol=TOL)
    keep = t != -100
    lp = torch.log_softmax(torch.from_numpy(lg), -1).numpy()
    np.testing.assert_allclose(got, -lp[keep, t[keep]].mean(), rtol=TOL)
    # every label ignored: the count is floored at 1, so 0 and not NaN
    allign = np.full(6, -100, np.int32)
    got, want = _both(lambda o, a, b: o.softmax_cross_entropy(
        a, b, ignore_index=-100), lg, allign)
    assert float(got) == float(want) == 0.0
    # float targets take the dense branch
    dense = np.eye(5, dtype=np.float32)[[1, 2, 3, 4, 0, 4]]
    got, want = _both(lambda o, a, b: o.softmax_cross_entropy(a, b), lg,
                      dense)
    np.testing.assert_allclose(got, want, rtol=TOL)


def test_binary_cross_entropy_eps_inside_the_log():
    p = np.array([0.0, 1.0, 0.3], np.float32)
    t = np.array([1.0, 0.0, 1.0], np.float32)
    got, want = _both(lambda o, a, b: o.binary_cross_entropy(
        a, b, reduction="none"), p, t)
    np.testing.assert_allclose(got, want, rtol=TOL)
    np.testing.assert_allclose(got[:2], -np.log(np.float32(1e-12)),
                               rtol=1e-5)
    clamped = F.binary_cross_entropy(torch.from_numpy(p), torch.from_numpy(t),
                                     reduction="none").numpy()
    assert clamped[0] == 100.0 and got[0] < 28.0


def test_kl_div_mean_is_over_every_element():
    lp = np.log(_positive(3, 4) / 8)
    t = _positive(3, 4, seed=1) / 8
    got, want = _both(lambda o, a, b: o.kl_div(a, b), lp, t)
    total, _ = _both(lambda o, a, b: o.kl_div(a, b, "sum"), lp, t)
    np.testing.assert_allclose(got, want, rtol=TOL)
    np.testing.assert_allclose(got, total / t.size, rtol=TOL)


def test_one_hot_out_of_range_gives_a_zero_row():
    ids = np.array([0, 3, 4, -1, 7], np.int32)
    got, want = _both(lambda o, i: o.one_hot(i, 4), ids)
    np.testing.assert_array_equal(got, want)
    assert (got[2:] == 0).all() and got.dtype == np.float32
    with pytest.raises(RuntimeError):
        F.one_hot(torch.from_numpy(ids).long(), 4)


def test_split_needs_an_even_division():
    x = _f32(2, 5)
    with pytest.raises(ValueError):
        jops.split(x, 2, axis=1)
    with pytest.raises(ValueError):
        pops.split(torch.from_numpy(x), 2, axis=1)
    with ht.graph("define_and_run", create_new=True, device="cpu"):
        with pytest.raises(ValueError):
            pops.split(ht.placeholder("float32", (2, 5)), 2, axis=1)
    assert len(torch.chunk(torch.from_numpy(x), 2, dim=1)) == 2


@pytest.mark.parametrize("shape,strides,offset", [
    ((4, 3), (2, 1), 6), ((3, 2), (-4, 1), 7), ((2, 2), (1, 1), -1)])
def test_as_strided_past_the_storage_raises(shape, strides, offset):
    x = _f32(3, 4)
    with pytest.raises(ValueError, match="exceeds storage") as jerr:
        jops.as_strided(x, shape, strides, offset)
    with pytest.raises(ValueError, match="exceeds storage") as perr:
        pops.as_strided(torch.from_numpy(x), shape, strides, offset)
    assert str(perr.value) == str(jerr.value)


def test_topk_of_distinct_values_matches_lax_top_k():
    x = _distinct(3, 7)
    (gv, gi), (jv, ji) = pops.topk(torch.from_numpy(x), 4), jops.topk(x, 4)
    np.testing.assert_array_equal(gv.numpy(), jv.numpy())
    np.testing.assert_array_equal(gi.numpy(), ji.numpy())
    assert gi.dtype == torch.int32


def test_parallel_attention_without_a_cp_mesh_raises_the_jax_error():
    q = _f32(1, 8, 2, 4)
    with jht.graph("define_and_run", create_new=True):
        jq = jht.placeholder("float32", q.shape)
        with pytest.raises(ValueError) as jerr:
            jops.parallel_attention(jq, jq, jq)
    with ht.graph("define_and_run", create_new=True, device="cpu"):
        pq = ht.placeholder("float32", q.shape)
        with pytest.raises(ValueError) as perr:
            pops.parallel_attention(pq, pq, pq)
    assert str(perr.value).startswith(str(jerr.value))
    assert "'cp'" in str(perr.value)


@pytest.mark.parametrize("fn", [
    lambda o: o.arange(7), lambda o: o.arange(2, 11, 3),
    lambda o: o.full((2, 3), 1.5), lambda o: o.zeros((4,)),
    lambda o: o.ones((2, 2), "int32")],
    ids=["arange", "arange_step", "full", "zeros", "ones_int32"])
def test_constructors(fn):
    want = np.asarray(fn(jops).numpy())
    eager = fn(pops)
    np.testing.assert_array_equal(eager.numpy(), want)
    assert eager.numpy().dtype == want.dtype
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        t = fn(pops)
        got = g.run([pops.add(t, 0)])[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_module_on_a_concrete_batch_runs_eagerly_only_when_asked():
    """In an eager graph a layer called on a torch tensor runs at once on
    its variables' current values (its output Tensor keeps the value);
    in a define-and-run graph it records, on a torch tensor as on a
    placeholder."""
    x = _f32(4, 6)
    with ht.graph("eager", create_new=True, device="cpu") as eg:
        elin = ht.nn.Linear(6, 3)
        y = elin(torch.from_numpy(x))
        assert y._data is not None and isinstance(y.get_data(),
                                                  torch.Tensor)
        ew, eb = elin.weight.numpy(), elin.bias.numpy()
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        lin = ht.nn.Linear(6, 3)
        before = len(g.ops)
        rec = lin(torch.from_numpy(x))
        assert not isinstance(rec, torch.Tensor) and len(g.ops) > before
        assert rec._data is None
        ph = ht.placeholder("float32", (4, 6))
        t = lin(ph)
        assert not isinstance(t, torch.Tensor)
        g.reset_variable(lin.weight, ew)
        g.reset_variable(lin.bias, eb)
        ref, got = g.run([t, rec], feed_dict={ph: x})
    np.testing.assert_allclose(y.numpy(), x @ ew.T + eb, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(y.numpy(), ref.numpy())
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_variable_beside_a_torch_constant_records_and_trains():
    """``mul(var, torch_mask)`` on a define-and-run graph is a recorded
    node with the mask as its constant: the variable gets its gradient
    and each run reads its current value."""
    mask = torch.tensor([1.0, 0.0, 2.0])
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        w = ht.parameter(ht.ConstantInitializer(1.0), (3,), name="w")
        loss = pops.reduce_sum(pops.mul(w, mask))
        assert not isinstance(loss, torch.Tensor)
        op = ht.optim.SGDOptimizer(lr=0.5).minimize(loss)
        losses = [g.run(loss, [loss, op])[0].item() for _ in range(2)]
        after = w.numpy()
    np.testing.assert_allclose(after, 1 - 2 * 0.5 * mask.numpy())
    assert losses == [3.0, 3.0 - 0.5 * 5.0]
