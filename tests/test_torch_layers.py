"""The port's layers and containers against the JAX package's, on the CPU.

Each layer is built in both packages; the JAX layer's ``state_dict()``
is carried into the port's by ``models.convert.load_module_state``, and
both run the same seeded numpy inputs through a define-and-run graph:
outputs and the gradients of ``sum(out * w)`` with respect to every
parameter and floating input, in fp32, within ``TOL`` = 1e-5.  Also:
``Sequential``/``ModuleList``/``ModuleDict`` names, the initializers'
shapes and ranges (their draws differ: the port draws from a
``torch.Generator``), dropout's mask, and ``BatchNorm2d``'s running
statistics -- moved by a forward in an eager graph exactly as the JAX
package's eager graph moves them (biased batch variance), left as they
are by a define-and-run step and its runs.
"""
import importlib
from collections import OrderedDict

import numpy as np
import pytest
import torch

import hetu_tpu as jht
from hetu_tpu import nn as jnn
from hetu_tpu import optim as joptim
import hetu_tpu_torch as ht
from hetu_tpu_torch import nn as pnn
from hetu_tpu_torch import optim as poptim
from hetu_tpu_torch.models.convert import (load_module_state,
                                           module_state_numpy)
from hetu_tpu_torch.ops import functional as pops

jops = importlib.import_module("hetu_tpu.ops.functional")
jctor = importlib.import_module("hetu_tpu.graph.ctor")
pctor = importlib.import_module("hetu_tpu_torch.graph.ctor")

TOL = 1e-5


def _f32(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _labels(n, k, seed=0):
    return np.random.RandomState(seed).randint(0, k, (n,)).astype(np.int32)


def _probs(*shape, seed=0):
    p = np.random.RandomState(seed).uniform(0.5, 2.0, shape)
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


# name -> (make(nn) -> module, inputs, indices of the floating inputs that
# are variables (the rest are fed placeholders))
LAYERS = {
    "Linear": (lambda n: n.Linear(6, 4), [_f32(3, 6)], (0,)),
    "Linear_no_bias": (lambda n: n.Linear(6, 4, bias=False), [_f32(2, 3, 6)],
                       (0,)),
    "Embedding": (lambda n: n.Embedding(10, 4),
                  [np.array([[1, 9, 0], [3, 3, 7]], np.int32)], ()),
    "LayerNorm": (lambda n: n.LayerNorm(6), [_f32(3, 6) * 2 + 1], (0,)),
    "RMSNorm": (lambda n: n.RMSNorm(6), [_f32(3, 6) * 2 + 1], (0,)),
    "BatchNorm2d": (lambda n: n.BatchNorm2d(3), [_f32(4, 3, 5, 5) * 2 + 1],
                    (0,)),
    "Conv2d": (lambda n: n.Conv2d(3, 4, 3, stride=2, padding=1),
               [_f32(2, 3, 8, 8)], (0,)),
    "Conv2d_no_bias": (lambda n: n.Conv2d(3, 2, (3, 1), bias=False),
                       [_f32(2, 3, 6, 6)], (0,)),
    "MaxPool2d": (lambda n: n.MaxPool2d(2), [_f32(2, 3, 6, 6)], (0,)),
    "AvgPool2d": (lambda n: n.AvgPool2d(3, 2, 1), [_f32(2, 3, 7, 7)], (0,)),
    "Dropout": (lambda n: n.Dropout(0.0), [_f32(3, 4)], (0,)),
    "Identity": (lambda n: n.Identity(), [_f32(3, 4)], (0,)),
    "ReLU": (lambda n: n.ReLU(), [_f32(3, 4)], (0,)),
    "GeLU": (lambda n: n.GeLU(), [_f32(3, 4)], (0,)),
    "GELU": (lambda n: n.GELU(), [_f32(3, 4)], (0,)),
    "SiLU": (lambda n: n.SiLU(), [_f32(3, 4)], (0,)),
    "Tanh": (lambda n: n.Tanh(), [_f32(3, 4)], (0,)),
    "Sigmoid": (lambda n: n.Sigmoid(), [_f32(3, 4)], (0,)),
    "LeakyReLU": (lambda n: n.LeakyReLU(0.1), [_f32(3, 4)], (0,)),
    "Softmax": (lambda n: n.Softmax(0), [_f32(3, 4)], (0,)),
    "NLLLoss": (lambda n: n.NLLLoss("sum"),
                [np.log(_probs(5, 4)), _labels(5, 4)], (0,)),
    "CrossEntropyLoss": (lambda n: n.CrossEntropyLoss(ignore_index=2),
                         [_f32(6, 4), _labels(6, 4, seed=1)], (0,)),
    "MSELoss": (lambda n: n.MSELoss(), [_f32(3, 4), _f32(3, 4, seed=1)],
                (0, 1)),
    "BCELoss": (lambda n: n.BCELoss(),
                [_probs(3, 4), (_f32(3, 4, seed=1) > 0).astype(np.float32)],
                (0,)),
    "BCELoss_logits": (lambda n: n.BCELoss("sum", with_logits=True),
                       [_f32(3, 4), (_f32(3, 4, seed=1) > 0)
                        .astype(np.float32)], (0,)),
    "KLDivLoss": (lambda n: n.KLDivLoss("sum"),
                  [np.log(_probs(3, 4)), _probs(3, 4, seed=1)], (0, 1)),
    "Sequential": (lambda n: n.Sequential(n.Linear(6, 5), n.ReLU(),
                                          n.Linear(5, 2)), [_f32(3, 6)],
                   (0,)),
}


def _run_layer(pkg, nn, name, state, train_mode=True):
    """(outputs and gradients, the module's state dict as numpy)."""
    make, arrays, diff = LAYERS[name]
    kw = {} if pkg is jht else {"device": "cpu"}
    with pkg.graph("define_and_run", create_new=True, **kw) as g:
        mod = make(nn)
        if not train_mode:
            mod.eval()
        if state is not None and pkg is jht:
            mod.load_state_dict(state)
        elif state is not None:
            load_module_state(mod, state)
        ins, feeds = [], {}
        for i, a in enumerate(arrays):
            if i in diff:
                ins.append(pkg.parameter(a, name=f"x{i}"))
            else:
                ins.append(pkg.placeholder(str(a.dtype), a.shape))
                feeds[ins[-1]] = a
        y = mod(*ins)
        o = jops if pkg is jht else pops
        w = np.asarray(np.random.RandomState(7).randn(*y.shape), np.float32)
        loss = o.reduce_sum(o.mul(y, w))
        xs = list(mod.parameters()) + [ins[i] for i in diff]
        fetch = [y]
        if xs:
            fetch += g.make_gradients(loss, xs)
        vals = g.run(fetch, feed_dict=feeds)
        st = {k: np.asarray(v) for k, v in mod.state_dict().items()} \
            if pkg is jht else module_state_numpy(mod)
    return [np.asarray(v) for v in vals], st


# every layer in training mode; the two whose eval mode differs, in it too
MODES = [(n, True) for n in sorted(LAYERS)] + \
    [("BatchNorm2d", False), ("Dropout", False)]


@pytest.mark.parametrize("name,train_mode", MODES,
                         ids=[f"{n}-{'train' if t else 'eval'}"
                              for n, t in MODES])
def test_layer_forward_and_gradients_match_jax(name, train_mode):
    jht.set_seed(3)
    want, jstate = _run_layer(jht, jnn, name, None, train_mode)
    if not train_mode and name == "BatchNorm2d":
        # running statistics away from their defaults
        jstate["running_mean"] = _f32(3, seed=5)
        jstate["running_var"] = np.abs(_f32(3, seed=6)) + 0.5
        want, _ = _run_layer(jht, jnn, name, jstate, train_mode)
    got, pstate = _run_layer(ht, pnn, name, jstate, train_mode)
    assert sorted(pstate) == sorted(jstate)
    for k in jstate:
        np.testing.assert_array_equal(pstate[k], jstate[k], err_msg=k)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                   err_msg=f"{name} fetch {i}")


def _jax_shapes(mod):
    return {k: tuple(np.shape(v)) for k, v in mod.state_dict().items()}


def _port_shapes(mod):
    return {k: tuple(v.shape) for k, v in module_state_numpy(mod).items()}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_parameter_names_and_shapes_match_jax(name):
    make = LAYERS[name][0]
    with jht.graph("define_and_run", create_new=True):
        want = _jax_shapes(make(jnn))
    with ht.graph("define_and_run", create_new=True, device="cpu"):
        got = _port_shapes(make(pnn))
    assert got == want


def _containers(nn):
    seq = nn.Sequential(OrderedDict([("fc", nn.Linear(4, 3)),
                                     ("act", nn.Tanh())]))
    lst = nn.ModuleList([nn.Linear(3, 3)])
    lst.append(nn.Linear(3, 2))
    d = nn.ModuleDict({"a": nn.Linear(2, 2)})
    d["b"] = nn.LayerNorm(2)
    root = nn.ModuleDict({"seq": seq, "lst": lst, "d": d})
    return root, seq, lst, d


def test_containers_name_and_index_as_in_jax():
    with jht.graph("define_and_run", create_new=True):
        jroot, jseq, jlst, jd = _containers(jnn)
        want = list(_jax_shapes(jroot).items())
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        root, seq, lst, d = _containers(pnn)
        got = list(_port_shapes(root).items())
        assert got == want
        assert len(seq) == 2 and isinstance(seq[1], pnn.Tanh)
        assert [type(m).__name__ for m in seq] == ["Linear", "Tanh"]
        assert len(lst) == 2 and lst[-1].out_features == 2
        assert list(d.keys()) == ["a", "b"] and d["b"] is dict(d.items())["b"]
        assert list(d.values())[0] is d["a"]
        x = ht.placeholder("float32", (2, 4))
        y = lst[1](lst[0](seq(x)))
        out = g.run([y], feed_dict={x: _f32(2, 4)})[0]
    assert tuple(out.shape) == (2, 2)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

SHAPE = (64, 48, 3, 3)             # fan_in 432, fan_out 576


@pytest.mark.parametrize("name,args,bound,std", [
    ("UniformInitializer", (0.3,), 0.3, 0.3 / np.sqrt(3)),
    ("TruncatedNormalInitializer", (0.5, 0.2), None, 0.2 * 0.8796),
    ("XavierUniformInitializer", (), np.sqrt(6 / (432 + 576)),
     np.sqrt(6 / (432 + 576)) / np.sqrt(3)),
    ("HeUniformInitializer", (), np.sqrt(6 / 432), np.sqrt(2 / 432)),
    ("HeNormalInitializer", (), None, np.sqrt(2 / 432)),
])
def test_initializers_shape_range_and_spread(name, args, bound, std):
    """Shape, dtype, range and spread as JAX's draws have them; the
    draws themselves differ."""
    want = np.asarray(getattr(jctor, name)(*args)(SHAPE, np.float32))
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        for dtype in (torch.float32, torch.bfloat16):
            got = getattr(pctor, name)(*args)(SHAPE, dtype, g)
            assert tuple(got.shape) == SHAPE and got.dtype == dtype
        got = got.float().numpy()
        seeded = [getattr(pctor, name)(*args, seed=4)(SHAPE, torch.float32, g)
                  for _ in range(2)]
    assert torch.equal(*seeded)
    for arr in (want, got):
        if bound is not None:
            assert np.abs(arr).max() <= bound * (1 + 2 ** -7)
        np.testing.assert_allclose(arr.std(), std, rtol=0.05)
    if name == "TruncatedNormalInitializer":
        for arr in (want, got):
            assert np.abs(arr - 0.5).max() <= 0.4 * (1 + 2 ** -7)
            np.testing.assert_allclose(arr.mean(), 0.5, atol=0.01)


def test_dropout_masks_and_scales():
    x = np.ones((64, 64), np.float32)
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        ph = ht.placeholder("float32", x.shape)
        drop = pnn.Dropout(0.25)
        y = drop(ph)
        a, = g.run([y], feed_dict={ph: x})
        b, = g.run([y], feed_dict={ph: x})
        drop.eval()
        assert drop(ph) is ph
    for v in (a, b):
        vals = set(np.unique(v.numpy()).tolist())
        assert vals == {0.0, float(np.float32(1 / 0.75))}
        assert abs((v.numpy() == 0).mean() - 0.25) < 0.03
    assert not torch.equal(a, b)


# ---------------------------------------------------------------------------
# BatchNorm2d's running statistics
# ---------------------------------------------------------------------------

def test_batchnorm_eager_updates_running_stats_as_jax_eager():
    x = _f32(4, 3, 5, 5, seed=2) * 2 + 1
    with jht.graph("eager", create_new=True):
        jbn = jnn.BatchNorm2d(3, momentum=0.2)
        jout = [jbn(x).numpy() for _ in range(2)]
        jstate = {k: np.asarray(v) for k, v in jbn.state_dict().items()}
    with ht.graph("eager", create_new=True, device="cpu") as g:
        bn = pnn.BatchNorm2d(3, momentum=0.2)
        out = [bn(torch.from_numpy(x)).get_data() for _ in range(2)]
        state = module_state_numpy(bn)
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(state[k], jstate[k], rtol=1e-6,
                                   err_msg=k)
    # the biased batch variance, where torch's BatchNorm folds in the
    # unbiased one
    var = x.var(axis=(0, 2, 3))
    np.testing.assert_allclose(state["running_var"],
                               0.64 + 0.36 * var, rtol=1e-6)
    tbn = torch.nn.BatchNorm2d(3, momentum=0.2)
    for _ in range(2):
        tbn(torch.from_numpy(x))
    assert np.abs(tbn.running_var.numpy() - state["running_var"]).min() > 1e-3
    # eval: the running statistics, as in the JAX package
    jbn.eval()
    with jht.graph("eager", create_new=True):
        jeval = jbn(x).numpy()
    bn.eval()
    with ht.graph(g):
        peval = bn(torch.from_numpy(x)).get_data()
    np.testing.assert_allclose(peval.numpy(),
                               np.asarray(jeval), rtol=TOL, atol=TOL)


def test_batchnorm_define_and_run_keeps_running_stats():
    """Define-and-run steps (the captured replays on the card run the same
    step body) leave the running statistics at their defaults in both
    packages, while the weights train."""
    x = _f32(4, 3, 5, 5, seed=2) * 2 + 1
    states = []
    for pkg, nn, opt, o, kw in (
            (jht, jnn, joptim, jops, {}),
            (ht, pnn, poptim, pops, {"device": "cpu"})):
        with pkg.graph("define_and_run", create_new=True, **kw) as g:
            bn = nn.BatchNorm2d(3)
            ph = pkg.placeholder("float32", x.shape)
            loss = o.reduce_sum(o.mul(bn(ph), x))
            op = opt.SGDOptimizer(lr=0.1).minimize(loss)
            for _ in range(3):
                g.run(loss, [loss, op], {ph: x})
            states.append({k: np.asarray(v) for k, v in
                           (bn.state_dict().items() if pkg is jht
                            else module_state_numpy(bn).items())})
    (jst, pst) = states
    for st in states:
        np.testing.assert_array_equal(st["running_mean"], np.zeros(3))
        np.testing.assert_array_equal(st["running_var"], np.ones(3))
    np.testing.assert_allclose(pst["weight"], jst["weight"], rtol=TOL,
                               atol=TOL)
    assert np.abs(pst["weight"] - 1).max() > 1e-3


def test_load_module_state_refuses_missing_extra_and_misshaped_names():
    with ht.graph("define_and_run", create_new=True, device="cpu"):
        mod = pnn.Sequential(pnn.Linear(3, 2), pnn.BatchNorm2d(2))
        good = module_state_numpy(mod)
        assert "1.running_mean" in good
        with pytest.raises(KeyError, match="missing"):
            load_module_state(mod, {k: v for k, v in good.items()
                                    if k != "1.running_var"})
        with pytest.raises(KeyError, match="unexpected"):
            load_module_state(mod, {**good, "2.weight": good["0.weight"]})
        with pytest.raises(ValueError, match="0.bias"):
            load_module_state(mod, {**good, "0.bias": np.zeros(3)})
        load_module_state(mod, {**good, "0.bias": np.ones(2, np.float32),
                                "1.running_mean": np.full(2, 3.0)})
        after = module_state_numpy(mod)
    np.testing.assert_array_equal(after["0.bias"], np.ones(2))
    np.testing.assert_array_equal(after["1.running_mean"], np.full(2, 3.0))
    assert after["1.running_mean"].dtype == np.float32
