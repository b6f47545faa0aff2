"""The port's lr schedules and optimizers against the JAX package's, on
the CPU.

Every schedule equals JAX's at steps 1-50 (1-based, float32); SGD (plain,
momentum, Nesterov), per-parameter Adafactor (factored and unfactored
parameters, momentum, weight decay, a scheduled lr) and AdamW with a
cosine lr train a tiny GPT-2 from the same weights on the same batches
for 10 steps through ``g.run``, and the losses and final parameters
agree within 1e-5 relative (fp32; the two sides sum in other orders).
"""
import numpy as np
import pytest
import torch

import hetu_tpu as jht
from hetu_tpu import optim as joptim
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPTLMHeadModel
from hetu_tpu.optim import schedules as jsched
import hetu_tpu_torch as ht
from hetu_tpu_torch import optim
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
from hetu_tpu_torch.models.convert import load_state, state_numpy
from hetu_tpu_torch.models.generate import _Params

# the tiny LLaMA of tests/test_torch_train.py: no biases.  A GPT-2 qkv
# bias has an exactly cancelling k part (softmax ignores a shift shared
# by all keys), whose round-off gradient Adam and Adafactor scale up to a
# full-size step in a random direction on either side
KW = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
          num_kv_heads=2, max_seq_len=16, sp=False, dropout=0.0,
          position="rotary", norm="rmsnorm", activation="swiglu")
B, S = 4, 16

SCHEDULES = {
    "constant": ("constant_schedule", (3e-4,)),
    "cosine": ("cosine_schedule", (1e-3, 10, 50, 1e-5)),
    "cosine_no_warmup": ("cosine_schedule", (1e-3, 0, 40)),
    "linear": ("linear_schedule", (1e-3, 5, 40, 1e-4)),
    "step_decay": ("step_decay_schedule", (1e-2, 0.5, 7)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_equals_jax_at_steps_1_to_50(name):
    fn, args = SCHEDULES[name]
    js, ps = getattr(jsched, fn)(*args), getattr(optim, fn)(*args)
    want = np.array([float(js(s)) for s in range(1, 51)], np.float32)
    got = np.array([float(ps(torch.tensor(float(s)))) for s in range(1, 51)],
                   np.float32)
    assert [float(ps(s)) for s in (1, 7)] == list(got[[0, 6]])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-10)


def test_schedules_refuse_total_not_past_warmup():
    with pytest.raises(ValueError, match="must exceed"):
        optim.cosine_schedule(1e-3, 10, 10)
    with pytest.raises(ValueError, match="must exceed"):
        optim.linear_schedule(1e-3, 10, 5)


@pytest.fixture(scope="module")
def state():
    jht.set_seed(7)
    with jht.graph("eager", create_new=True):
        model = JaxGPTLMHeadModel(JaxGPTConfig(**KW))
        model.logits(np.zeros((1, 4), np.int32))
        return {k: np.asarray(v) for k, v in model.state_dict().items()}


def _batches(n=10):
    rng = np.random.RandomState(11)
    return [(rng.randint(0, 97, (B, S)).astype(np.int32),
             rng.randint(0, 97, (B, S)).astype(np.int32)) for _ in range(n)]


def _train_jax(state, make_opt, batches):
    with jht.graph("define_and_run", create_new=True) as g:
        ids = jht.placeholder("int32", (B, S), name="input_ids")
        labels = jht.placeholder("int32", (B, S), name="labels")
        model = JaxGPTLMHeadModel(JaxGPTConfig(**KW))
        loss = model(ids, labels)
        train_op = make_opt(joptim, jsched).minimize(loss)
        model.load_state_dict(state)
    losses = [float(np.asarray(g.run(loss, [loss, train_op],
                                     {ids: x, labels: y})[0]))
              for x, y in batches]
    return losses, {_Params._norm(k): np.asarray(v)
                    for k, v in model.state_dict().items()}


def _train_port(state, make_opt, batches):
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        ids = ht.placeholder("int32", (B, S), name="input_ids")
        labels = ht.placeholder("int32", (B, S), name="labels")
        model = GPTLMHeadModel(GPTConfig(**KW))
        loss = model(ids, labels)
        train_op = make_opt(optim, optim).minimize(loss)
        load_state(model, state)
    losses = [float(g.run(loss, [loss, train_op], {ids: x, labels: y})[0])
              for x, y in batches]
    return losses, state_numpy(model)


OPTIMIZERS = {
    "sgd": lambda o, s: o.SGDOptimizer(lr=0.1),
    "sgd_momentum": lambda o, s: o.SGDOptimizer(lr=0.02, momentum=0.9),
    "sgd_nesterov": lambda o, s: o.SGDOptimizer(lr=0.02, momentum=0.9,
                                                nesterov=True),
    "sgd_cosine": lambda o, s: o.SGDOptimizer(
        lr=s.cosine_schedule(0.1, 3, 10), momentum=0.5),
    # hidden 32: dims of 16 and more factor (the projections and the
    # vocab x 32 matrices), the norms keep a full second moment
    "adafactor": lambda o, s: o.AdafactorOptimizer(
        lr=1e-2, min_dim_size_to_factor=16),
    "adafactor_recipe": lambda o, s: o.AdafactorOptimizer(
        lr=s.linear_schedule(2e-2, 2, 10), min_dim_size_to_factor=16,
        momentum=0.9, weight_decay_rate=1e-3),
    "adafactor_unfactored": lambda o, s: o.AdafactorOptimizer(
        lr=1e-2, min_dim_size_to_factor=1000, clipping_threshold=None),
    "adamw_cosine": lambda o, s: o.AdamWOptimizer(
        lr=s.cosine_schedule(1e-3, 3, 10, 1e-4), weight_decay=0.01),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_ten_steps_equal_jax(name, state):
    batches = _batches()
    jl, jw = _train_jax(state, OPTIMIZERS[name], batches)
    pl, pw = _train_port(state, OPTIMIZERS[name], batches)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[-1] < pl[0]
    assert sorted(pw) == sorted(jw)
    for k in jw:
        np.testing.assert_allclose(pw[k], jw[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_scheduled_lr_reads_the_device_step():
    """The lr is computed from the step tensor on each step, not frozen
    at the first: two steps of a fast-decaying schedule move the weights
    by the schedule's two values (SGD, a constant gradient)."""
    from hetu_tpu_torch.graph import parameter
    from hetu_tpu_torch.ops import functional as ops
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        w = parameter(np.zeros((3,), np.float32), name="w")
        loss = ops.reduce_sum(w)
        opt = optim.SGDOptimizer(lr=optim.step_decay_schedule(1.0, 0.5, 1))
        op = opt.minimize(loss)
    seen = []
    for _ in range(3):
        before = w.get_data().clone()
        g.run(loss, [loss, op])
        seen.append(float((before - w.get_data())[0]))
    assert seen == [0.5, 0.25, 0.125]
    assert float(opt._state["step"]) == 3.0


def test_refusals_of_later_slices():
    """ZeRO and the grad-comm transports are taken (their tests:
    tests/test_torch_parallel.py); flat Adafactor is refused by name,
    and flat state without a transport as in the JAX package."""
    for kw in (dict(zero=1), dict(zero=2), dict(grad_comm="bf16")):
        optim.AdafactorOptimizer(**kw)
    with pytest.raises(NotImplementedError, match="item 10b"):
        optim.AdafactorOptimizer(zero=2, flat_state=True, grad_comm="fp32")
    with pytest.raises(ValueError, match="grad-comm"):
        optim.AdafactorOptimizer(zero=2, flat_state=True)
