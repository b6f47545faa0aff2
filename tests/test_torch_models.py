"""The port's BERT, CNN, RNN and CTR models against the JAX package's, on
the CPU.

Each model is built at a small size in both packages' define-and-run
graphs; the JAX model's ``state_dict()`` (BatchNorm buffers included) is
carried into the port's by ``models.convert.load_module_state``.  Both
run the same seeded numpy batch: the forward output, then the loss of
each of 3 Adam steps (lr 1e-3: Adam moves every weight by about lr
whatever its gradient, so a gradient that cancels to rounding noise can
move a weight by the other sign; 1e-3 keeps that inside the limit) and
every parameter after them, in fp32 within ``TOL`` = 2e-5.  The JAX side
of each model runs once for the module (``jax_run``).

The models' reshapes keep the batch axis free, so the port also trains
them in micro-batches: two micro-batches give the whole batch's step
(models without BatchNorm, whose batch statistics depend on the split).
"""
import importlib

import numpy as np
import pytest

import hetu_tpu as jht
from hetu_tpu import optim as joptim
import hetu_tpu_torch as ht
from hetu_tpu_torch import models as pmodels
from hetu_tpu_torch import optim as poptim
from hetu_tpu_torch.models.convert import (load_module_state,
                                           module_state_numpy)
from hetu_tpu_torch.ops import functional as pops

jmodels = importlib.import_module("hetu_tpu.models")
jops = importlib.import_module("hetu_tpu.ops.functional")

TOL = 2e-5
STEPS = 3
LR = 1e-3


def _rng(seed):
    return np.random.RandomState(seed)


def _bert_batch(b=4, s=16, vocab=64):
    r = _rng(0)
    tt = np.zeros((b, s), np.int32)
    tt[:, s // 2:] = 1
    mlm = np.where(r.rand(b, s) < 0.3, r.randint(0, vocab, (b, s)), -100)
    return [("int32", r.randint(0, vocab, (b, s)).astype(np.int32)),
            ("int32", tt), ("int32", mlm.astype(np.int32)),
            ("int32", r.randint(0, 2, (b,)).astype(np.int32))]


def _image_batch(b, c=3, hw=32, classes=10):
    r = _rng(1)
    return [("float32", r.randn(b, c, hw, hw).astype(np.float32)),
            ("int32", r.randint(0, classes, (b,)).astype(np.int32))]


def _lm_batch(b=4, s=8, vocab=32):
    r = _rng(2)
    return [("int32", r.randint(0, vocab, (b, s)).astype(np.int32)),
            ("int32", r.randint(0, vocab, (b, s)).astype(np.int32))]


CTR = dict(num_sparse_fields=4, vocab_size=50, embedding_dim=4, num_dense=3)


def _ctr_batch(b=8):
    r = _rng(3)
    ids = r.randint(0, CTR["vocab_size"], (b, CTR["num_sparse_fields"]))
    return [("int32", ids.astype(np.int32)),
            ("float32", r.randn(b, CTR["num_dense"]).astype(np.float32)),
            ("float32", (r.rand(b) < 0.3).astype(np.float32))]


BERT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=16)


def _ctr(cls, **kw):
    """(make, loss, logits) of a CTR model: ctr_loss over its logits."""
    def make(m):
        return getattr(m, cls)(**CTR, **kw)

    def loss(m, o, model, ids, dense, y):
        return m.ctr_loss(model(ids, dense), y)

    def logits(m, o, model, ids, dense, y):
        return model(ids, dense)
    return make, loss, logits


def _labelled(make):
    """(make, loss, logits) of a model whose forward takes labels last."""
    return (make, lambda m, o, model, *xs: model(*xs),
            lambda m, o, model, *xs: model(*xs[:-1]))


# name -> (make(models), loss(models, ops, model, *inputs),
#          forward(models, ops, model, *inputs), batch)
MODELS = {
    "bert_pretraining": (
        lambda m: m.BertForPreTraining(m.BertConfig(**BERT)),
        lambda m, o, model, *xs: model(*xs),
        lambda m, o, model, ids, tt, mlm, nsp: model(ids, tt),
        _bert_batch()),
    "bert_classification": (
        lambda m: m.BertForSequenceClassification(m.BertConfig(**BERT), 3),
        lambda m, o, model, ids, tt, mlm, nsp: model(ids, nsp, tt),
        lambda m, o, model, ids, tt, mlm, nsp: model(ids, None, tt),
        _bert_batch()),
    "simple_cnn": (*_labelled(lambda m: m.SimpleCNN()), _image_batch(2)),
    "resnet_2_stages": (*_labelled(lambda m: m.ResNet(
        10, stages=(1, 1), widths=(8, 16))), _image_batch(4, hw=8)),
    "rnn_lm": (*_labelled(lambda m: m.RNNLanguageModel(32, 16, "rnn", 2)),
               _lm_batch()),
    "gru_lm": (*_labelled(lambda m: m.RNNLanguageModel(32, 16, "gru", 2)),
               _lm_batch()),
    "lstm_lm": (*_labelled(lambda m: m.RNNLanguageModel(32, 16, "lstm", 2)),
                _lm_batch()),
    "wdl": (*_ctr("WDL", hidden=(16, 8)), _ctr_batch()),
    "deepfm": (*_ctr("DeepFM", hidden=(16, 8)), _ctr_batch()),
    "dcn": (*_ctr("DCN", num_cross=2, hidden=(16, 8)), _ctr_batch()),
}


def _train(pkg, name, state=None, micro=1):
    """(initial state, forward output, losses, final state) of ``name``
    in ``pkg``'s graph; ``state`` is loaded first when given."""
    make, loss_fn, fwd_fn, batch = MODELS[name]
    m, o, opt = (jmodels, jops, joptim) if pkg is jht else \
        (pmodels, pops, poptim)
    kw = {} if pkg is jht else {"device": "cpu"}
    with pkg.graph("define_and_run", create_new=True, **kw) as g:
        phs = [pkg.placeholder(dt, a.shape) for dt, a in batch]
        model = make(m)
        loss = loss_fn(m, o, model, *phs)
        out = fwd_fn(m, o, model, *phs)
        train_op = opt.AdamOptimizer(lr=LR).minimize(loss)
        if state is not None:
            load_module_state(model, state)
    feeds = {p: a for p, (_, a) in zip(phs, batch)}

    def snapshot():
        if pkg is jht:
            return {k: np.asarray(v) for k, v in model.state_dict().items()}
        return module_state_numpy(model)

    init = snapshot()
    fwd = np.asarray(g.run([out], feed_dict=feeds)[0])
    losses = [float(np.asarray(g.run(loss, [loss, train_op], feeds,
                                     num_micro_batches=micro)[0]))
              for _ in range(STEPS)]
    return init, fwd, losses, snapshot()


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    """The JAX run (once for the module) and the port's from its
    weights."""
    jht.set_seed(11)
    jax_run = _train(jht, request.param)
    return request.param, jax_run, _train(ht, request.param, jax_run[0])


def test_state_names_and_shapes_match_jax(pair):
    _, (jinit, *_), (pinit, *_) = pair
    assert {k: v.shape for k, v in pinit.items()} == \
        {k: v.shape for k, v in jinit.items()}
    for k in jinit:
        np.testing.assert_array_equal(pinit[k], jinit[k], err_msg=k)


def test_forward_matches_jax(pair):
    name, (_, jfwd, *_), (_, pfwd, *_) = pair
    assert pfwd.shape == jfwd.shape
    np.testing.assert_allclose(pfwd, jfwd, rtol=TOL, atol=TOL, err_msg=name)


def test_three_adam_steps_match_jax(pair):
    name, (_, _, jl, jfinal), (_, _, pl, pfinal) = pair
    np.testing.assert_allclose(pl, jl, rtol=TOL, err_msg=name)
    assert pl[-1] < pl[0]
    for k in jfinal:
        np.testing.assert_allclose(pfinal[k], jfinal[k], rtol=TOL, atol=TOL,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", ["bert_classification", "simple_cnn",
                                  "lstm_lm", "gru_lm", "dcn", "deepfm"])
def test_micro_batches_give_the_whole_batch_step(name):
    with ht.graph("define_and_run", create_new=True, device="cpu"):
        init = module_state_numpy(MODELS[name][0](pmodels))
    _, _, whole, wfinal = _train(ht, name, init, micro=1)
    _, _, split, sfinal = _train(ht, name, init, micro=2)
    np.testing.assert_allclose(split, whole, rtol=TOL)
    for k in wfinal:
        np.testing.assert_allclose(sfinal[k], wfinal[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("cell", ["RNN", "GRU", "LSTM"])
def test_recurrent_layer_with_initial_state_matches_jax(cell):
    """One layer from a given initial state: every step's output and the
    final hidden state, and their gradients' effect through a loss."""
    r = _rng(4)
    x = r.randn(3, 5, 6).astype(np.float32)
    h0 = r.randn(3, 4).astype(np.float32)
    c0 = r.randn(3, 4).astype(np.float32)
    w = r.randn(3, 5, 4).astype(np.float32)
    init = (h0, c0) if cell == "LSTM" else h0
    results = []
    for pkg, m, o in ((jht, jmodels, jops), (ht, pmodels, pops)):
        kw = {} if pkg is jht else {"device": "cpu"}
        with pkg.graph("define_and_run", create_new=True, **kw) as g:
            layer = getattr(m, cell)(6, 4, name="cell")
            if pkg is ht:
                load_module_state(layer, results[0][2])
            xp = pkg.placeholder("float32", x.shape)
            ys, h = layer(xp, init)
            loss = o.reduce_sum(o.mul(ys, w))
            grads = g.make_gradients(loss, list(layer.parameters()))
            vals = g.run([ys, h, *grads], feed_dict={xp: x})
            st = {k: np.asarray(v) for k, v in layer.state_dict().items()} \
                if pkg is jht else module_state_numpy(layer)
        results.append(([np.asarray(v) for v in vals], None, st))
    (jv, _, _), (pv, _, _) = results
    assert pv[0].shape == (3, 5, 4) and pv[1].shape == (3, 4)
    for i, (a, b) in enumerate(zip(pv, jv)):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                   err_msg=f"{cell} fetch {i}")
