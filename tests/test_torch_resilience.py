"""The port's resilience plane against the JAX package's, on the CPU.

- ``NumericSentry.update`` gives the JAX verdict vector and state (within
  1e-6) on seeded cases: NaN and Inf losses, a NaN gradient norm, a norm
  spike, a loss spike before and after the warm-up, clean steps; the
  injection factors are JAX's;
- JAX's sentry tests mirrored on the port's tiny GPT (2 layers, fp32,
  dropout 0, one JAX state): a skipped step leaves bitwise-zero residue
  and the clean steps equal a run that never saw it; the loss-spike
  verdict needs its warm-up; a step makes as many host reads with the
  sentry as without (counted ``item``, ``cpu``, ``tolist``, ``numpy`` and
  ``__float__`` calls); poisoned and clean steps run one plan; losses
  within 1e-5 of JAX's on the same steps; Adafactor's factored
  statistics and EMA too, its next clean step against JAX's Adafactor;
- flat ZeRO-2 on 4 gloo ranks (tests/torch_ranks.py) against JAX's
  ``test_sentry_flat_zero2_skip_and_step_counter`` on 4 CPU devices:
  losses within 1e-5, the step counter equal; and a fault injected on one
  rank only takes the same verdict on every rank;
- checkpoint generations: verify, fallback past a corrupt one,
  kill-mid-write, resaving the same step, retention, stale shards (JAX's
  tests/test_resilience.py cases), and generations cross both ways;
- the background save from several processes, with a coordinator (JAX
  loads it) and without one (refused).
"""
import os

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import hetu_tpu as jht
from hetu_tpu import optim as joptim
from hetu_tpu import resilience as jres
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPTLMHeadModel
from hetu_tpu.resilience import sentry as jsentry
from hetu_tpu.utils import checkpoint as jckpt
import hetu_tpu_torch as ht
from hetu_tpu_torch import optim
from hetu_tpu_torch import resilience as pres
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
from hetu_tpu_torch.models.convert import load_state
from hetu_tpu_torch.resilience import sentry as psentry
from hetu_tpu_torch.utils import checkpoint as pckpt
from torch_ranks import FT_CFG, run_ranks

# cursor c trains on TABLE[c] (tests/test_resilience.py's table)
TABLE = np.random.RandomState(42).randint(0, 64, (64, 8, 16)) \
    .astype(np.int32)


def _jax_state():
    jht.set_seed(3)
    with jht.graph("eager", create_new=True):
        model = JaxGPTLMHeadModel(JaxGPTConfig(**FT_CFG))
        model.logits(np.zeros((1, 4), np.int32))
        return {k: np.asarray(v) for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def state():
    return _jax_state()


@pytest.fixture(scope="module")
def state_files(state, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resilience")
    np.savez(tmp / "state.npz", **state)
    np.save(tmp / "table.npy", TABLE)
    return tmp, str(tmp / "state.npz"), str(tmp / "table.npy")


# ---------------------------------------------------------------------------
# the verdict: update and the injection seam against JAX's
# ---------------------------------------------------------------------------

NAN, INF = float("nan"), float("inf")
# (ema, seen, consecutive), loss, grad sum of squares
VERDICT_CASES = {
    "clean_first": ((0.0, 0, 0), 4.2, 0.81),
    "clean_warm": ((4.1, 5, 0), 4.0, 0.5),
    "nan_loss": ((4.1, 5, 0), NAN, 0.5),
    "inf_loss": ((4.1, 5, 2), INF, 0.5),
    "nan_grad": ((4.1, 5, 1), 4.0, NAN),
    "inf_grad": ((4.1, 5, 0), 4.0, INF),
    "grad_spike": ((4.1, 5, 0), 4.0, 1e10),
    "loss_spike_before_warmup": ((4.1, 1, 0), 4.0 * 64, 0.5),
    "loss_spike_after_warmup": ((4.1, 2, 0), 4.0 * 64, 0.5),
    "loss_just_below_spike": ((4.1, 3, 0), 32.7, 0.5),
}


def _verdict_equal(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(want)), (got, want)
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=tol, atol=tol)


@pytest.mark.parametrize("case", sorted(VERDICT_CASES))
def test_sentry_verdict_matches_jax(case):
    import jax.numpy as jnp
    (ema, seen, cons), loss, sq = VERDICT_CASES[case]
    js = jsentry.NumericSentry()
    jstate = {"ema": jnp.float32(ema), "seen": jnp.int32(seen),
              "consecutive": jnp.int32(cons),
              "verdict": jnp.zeros((jsentry.VERDICT_SLOTS,), jnp.float32)}
    jok, jnew = js.update(jnp.float32(loss), jnp.float32(sq), jstate)
    ps = psentry.NumericSentry()
    st = ps.init_state("cpu")
    st["ema"].fill_(ema)
    st["seen"].fill_(seen)
    st["consecutive"].fill_(cons)
    pok = ps.update(torch.tensor(loss, dtype=torch.float32),
                    torch.tensor(sq, dtype=torch.float32))
    assert bool(pok) == bool(jok)
    _verdict_equal(st["verdict"].numpy(), np.asarray(jnew["verdict"]))
    _verdict_equal([float(st["ema"])], [float(jnew["ema"])])
    assert int(st["seen"]) == int(jnew["seen"])
    assert int(st["consecutive"]) == int(jnew["consecutive"])
    assert psentry.decode_verdict(st["verdict"].numpy()).keys() == \
        jsentry.decode_verdict(np.asarray(jnew["verdict"])).keys()
    assert ps.meta() == js.meta()


@pytest.mark.parametrize("code", [0, 1, 2, 3])
def test_injection_factors_match_jax(code):
    import jax.numpy as jnp
    g = np.random.RandomState(code).randn(5, 3).astype(np.float32)
    js, ps = jsentry.NumericSentry(), psentry.NumericSentry()
    want = js.inject_grads({0: jnp.asarray(g)}, jnp.int32(code))[0]
    got = ps.inject_grads([torch.from_numpy(g)],
                          torch.tensor(code, dtype=torch.int32))[0]
    _verdict_equal(got.numpy().ravel(), np.asarray(want).ravel(), tol=0)
    wl = js.inject_loss(jnp.float32(2.5), jnp.int32(code))
    gl = ps.inject_loss(torch.tensor(2.5), torch.tensor(code))
    assert float(gl) == float(wl)
    if code == 0:
        assert torch.equal(got, torch.from_numpy(g))   # a bitwise identity


# ---------------------------------------------------------------------------
# the sentry in a step: JAX's tests mirrored
# ---------------------------------------------------------------------------

class _Port:
    """tests/test_resilience.py's ``_single_build`` in the port, from the
    JAX state (batch 4 of the table's rows)."""

    def __init__(self, state, sentry=True, opt="AdamOptimizer", **opt_kw):
        with ht.graph("define_and_run", create_new=True, device="cpu",
                      seed=0) as g:
            self.ids = ht.placeholder("int32", (4, 16))
            self.labels = ht.placeholder("int32", (4, 16))
            self.model = GPTLMHeadModel(GPTConfig(**FT_CFG))
            self.loss = self.model(self.ids, self.labels)
            self.opt = getattr(optim, opt)(lr=1e-2, sentry=sentry, **opt_kw)
            self.op = self.opt.minimize(self.loss)
        load_state(self.model, state)
        self.g = g

    def run(self, cursor):
        b = TABLE[cursor][:4]
        return self.g.run(self.loss, [self.loss, self.op],
                          {self.ids: b, self.labels: np.roll(b, -1, 1)})

    def step(self, cursor):
        return float(self.run(cursor)[0])

    def params(self):
        return {k: v.detach().clone() for k, v in
                self.model.state_dict().items()}


class _Jax:
    def __init__(self, state, sentry=True, opt="AdamOptimizer", **opt_kw):
        with jht.graph("define_and_run", create_new=True) as g:
            self.ids = jht.placeholder("int32", (4, 16))
            self.labels = jht.placeholder("int32", (4, 16))
            self.model = JaxGPTLMHeadModel(JaxGPTConfig(**FT_CFG))
            self.loss = self.model(self.ids, self.labels)
            self.opt = getattr(joptim, opt)(lr=1e-2, sentry=sentry,
                                            **opt_kw)
            self.op = self.opt.minimize(self.loss)
            self.model.load_state_dict(state)
        self.g = g

    def step(self, cursor):
        b = TABLE[cursor][:4]
        out = self.g.run(self.loss, [self.loss, self.op],
                         {self.ids: b, self.labels: np.roll(b, -1, 1)})
        return float(np.asarray(out[0]))


def _bitwise(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_sentry_skip_is_bitwise_zero_residue(state):
    p = _Port(state)
    losses = [p.step(0), p.step(1)]
    p.g.inject_numeric_fault("grad_nan")
    p.step(2)
    v = p.opt.sentry.last_verdict()
    assert v["anomaly"] and v["grad_nonfinite"] and v["consecutive"] == 1
    assert not v["loss_nonfinite"] and np.isnan(v["grad_norm"])
    assert float(p.opt._state["step"]) == 2.0
    losses.append(p.step(3))
    v2 = p.opt.sentry.last_verdict()
    assert not v2["anomaly"] and v2["consecutive"] == 0
    assert v2["grad_norm"] > 0
    assert len(p.g._plan_pool) == 1, "the injection made a second plan"
    ref = _Port(state)
    want = [ref.step(c) for c in (0, 1, 3)]
    assert want == losses, "clean-step losses are not bitwise equal"
    assert _bitwise(p.params(), ref.params()), "the skip left residue"
    # the JAX package on the same steps
    j = _Jax(state)
    jl = [j.step(0), j.step(1)]
    j.g.inject_numeric_fault("grad_nan")
    j.step(2)
    assert j.opt.sentry.last_verdict()["grad_nonfinite"]
    jl.append(j.step(3))
    np.testing.assert_allclose(losses, jl, rtol=1e-5)


# factored at the tiny widths (min_dim 16), with a momentum EMA
ADAFACTOR_KW = dict(opt="AdafactorOptimizer", min_dim_size_to_factor=16,
                    momentum=0.9)


def test_sentry_skip_leaves_adafactor_state_bitwise(state):
    """A skipped step leaves Adafactor's factored row and column
    statistics, its unfactored second moments, its EMA and its counters
    bitwise as they were; the next clean step equals JAX's Adafactor with
    ``sentry=True`` on the same steps."""
    p = _Port(state, **ADAFACTOR_KW)
    losses = [p.step(0), p.step(1)]
    st = p.opt._state
    assert any(v.numel() > 1 for v in st["v_row"].values()), \
        "no parameter is factored"
    before = [v.clone() for v in p.opt._leaves()]
    params = p.params()
    p.g.inject_numeric_fault("grad_nan")
    p.step(2)
    assert p.opt.sentry.last_verdict()["grad_nonfinite"]
    after = p.opt._leaves()
    assert len(after) == len(before) and \
        all(torch.equal(a, b) for a, b in zip(before, after)), \
        "the skip moved Adafactor's state"
    assert _bitwise(params, p.params()), "the skip left residue"
    losses += [p.step(3), p.step(4)]
    ref = _Port(state, **ADAFACTOR_KW)
    assert [ref.step(c) for c in (0, 1, 3, 4)] == losses
    assert _bitwise(p.params(), ref.params())
    j = _Jax(state, **ADAFACTOR_KW)
    jl = [j.step(0), j.step(1)]
    j.g.inject_numeric_fault("grad_nan")
    j.step(2)
    assert j.opt.sentry.last_verdict()["grad_nonfinite"]
    jl += [j.step(3), j.step(4)]
    np.testing.assert_allclose(losses, jl, rtol=1e-5)
    # the weights as tests/test_torch_optim.py holds them, but for the k
    # third of a qkv bias: softmax ignores a shift shared by all keys, so
    # its gradient is round-off, which Adafactor scales up to a full-size
    # step in a random direction
    jp = {k: np.asarray(v) for k, v in j.model.state_dict().items()}
    for k, v in p.params().items():
        ours, theirs = v.numpy(), jp[k]
        if k.endswith("attn.qkv.bias"):
            h = FT_CFG["hidden_size"]
            keep = np.r_[0:h, 2 * h:3 * h]
            ours, theirs = ours[keep], theirs[keep]
        np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_sentry_loss_spike_needs_warmup_and_fires(state):
    p, j = _Port(state), _Jax(state)
    for m in (p, j):
        m.step(0)
        m.g.inject_numeric_fault("loss_spike")
        m.step(1)
        v = m.opt.sentry.last_verdict()
        assert not v["loss_spike"], "spike verdict fired during warmup"
        m.step(2), m.step(3)
    before = p.params()
    spikes = []
    for m in (p, j):
        m.g.inject_numeric_fault("loss_spike")
        spikes.append(m.step(4))
        v = m.opt.sentry.last_verdict()
        assert v["anomaly"] and v["loss_spike"] and not v["grad_spike"]
    assert spikes[0] > 4 * p.opt.sentry.config.loss_spike_factor / 8.0
    np.testing.assert_allclose(spikes[0], spikes[1], rtol=1e-5)
    assert _bitwise(before, p.params()), "loss-spike step updated params"


class _Reads:
    """Counts the calls that read a tensor to the host, leaving out reads
    of the host copy a sentried step hands over (``sentry`` given)."""

    NAMES = ("item", "cpu", "tolist", "numpy", "__float__")

    def __init__(self, monkeypatch, sentry=None):
        self.n = 0
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)

            def wrap(t, *a, _orig=orig, **k):
                host = sentry is not None and \
                    sentry._host_packet is not None and \
                    t.untyped_storage().data_ptr() == \
                    sentry._host_packet.untyped_storage().data_ptr()
                if not host:
                    self.n += 1
                return _orig(t, *a, **k)
            monkeypatch.setattr(torch.Tensor, name, wrap)


def test_sentry_zero_extra_host_transfers(state, monkeypatch):
    """A step reads the loss to the host once with the sentry off (the
    caller's read) and once with it on (the graph's one copy of the loss
    and the verdict); the verdict and the loss are then read from that
    copy.  JAX's pin: one verdict read an attempt, one plan."""
    off, on = _Port(state, sentry=False), _Port(state)
    for m in (off, on):
        m.step(0)                     # the plan's first run apart
    with monkeypatch.context() as mp:
        reads = _Reads(mp)
        float(off.run(1)[0])
        n_off = reads.n
    with monkeypatch.context() as mp:
        reads = _Reads(mp, on.opt.sentry)
        r0 = on.opt.sentry.host_reads
        for c in (1, 2, 3):
            if c == 3:
                on.g.inject_numeric_fault("grad_spike")
            float(on.run(c)[0])
            on.opt.sentry.last_verdict()
        n_on = reads.n
    assert n_off == 1 and n_on == 3, (n_off, n_on)
    assert on.opt.sentry.host_reads - r0 == 3
    assert len(on.g._plan_pool) == 1
    assert on.opt.sentry.last_verdict()["grad_spike"]


def test_sentry_needs_the_loss_fetch(state):
    p = _Port(state)
    b = TABLE[0][:4]
    with pytest.raises(ValueError, match="loss among the fetches"):
        p.g.run([p.op], feed_dict={p.ids: b, p.labels: b})
    with pytest.raises(ValueError, match="sentry must be"):
        optim.AdamOptimizer(lr=1e-2, sentry="yes")


def test_sentry_with_grad_scaler_and_sgd_velocity(state):
    """A skipped step leaves SGD's velocity as it was; a scaler still
    backs off on a non-finite step (the JAX scope note)."""
    with ht.graph("define_and_run", create_new=True, device="cpu",
                  seed=0) as g:
        ids = ht.placeholder("int32", (4, 16))
        labels = ht.placeholder("int32", (4, 16))
        model = GPTLMHeadModel(GPTConfig(**FT_CFG))
        loss = model(ids, labels)
        opt = optim.SGDOptimizer(lr=1e-2, momentum=0.9, sentry=True)
        scaler = ht.GradScaler(init_scale=2.0 ** 4)
        op = opt.minimize(loss, grad_scaler=scaler)
    load_state(model, state)
    b = TABLE[0][:4]
    feed = {ids: b, labels: np.roll(b, -1, 1)}
    g.run(loss, [loss, op], feed)
    vel = {k: v.clone() for k, v in opt._state["velocity"].items()}
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    g.inject_numeric_fault("grad_nan")
    g.run(loss, [loss, op], feed)
    assert opt.sentry.last_verdict()["grad_nonfinite"]
    assert scaler.scale == 2.0 ** 3
    assert all(torch.equal(vel[k], v)
               for k, v in opt._state["velocity"].items())
    assert _bitwise(params, {k: v.detach() for k, v in
                             model.state_dict().items()})


# ---------------------------------------------------------------------------
# on gloo ranks: flat ZeRO-2 against JAX's 4 devices, one-rank faults
# ---------------------------------------------------------------------------

def _jax_flat(devices, state, **opt_kw):
    mesh = jht.create_mesh({"dp": len(devices)}, devices)
    with jht.graph("define_and_run", create_new=True, mesh=mesh) as g:
        ids = jht.parallel_placeholder("int32", (8, 16), pspec=JP("dp", None),
                                       name="ids")
        labels = jht.parallel_placeholder("int32", (8, 16),
                                          pspec=JP("dp", None), name="labels")
        model = JaxGPTLMHeadModel(JaxGPTConfig(**FT_CFG))
        loss = model(ids, labels)
        opt = joptim.AdamOptimizer(lr=1e-2, zero=2, grad_comm="fp32",
                                   flat_state=True, sentry=True, **opt_kw)
        op = opt.minimize(loss)
        model.load_state_dict(state)

    def step(c):
        b = TABLE[c]
        out = g.run(loss, [loss, op], {ids: b, labels: np.roll(b, -1, 1)})
        return float(np.asarray(out[0]))
    return g, opt, step


def test_sentry_flat_zero2_skip_and_step_counter(state, state_files,
                                                 devices8):
    tmp, sp, tp = state_files
    port = run_ranks("sentry_flat", 4, {"state_path": sp, "table_path": tp},
                     tmp, timeout=150.0)
    g, opt, step = _jax_flat(devices8[:4], state, max_grad_norm=1.0)
    jl = [step(0), step(1)]
    g.inject_numeric_fault("grad_spike")
    step(2)
    jv = opt.sentry.last_verdict()
    jl.append(step(3))
    for r in port:
        assert r["losses"] == r["ref_losses"] and r["weights_bitwise"]
        assert r["step_counter"] == [2.0, 2.0, 3.0]
        assert r["ref_step_counter"] == 3.0
        v = r["verdict"]
        assert v["anomaly"] and v["grad_spike"] and not v["grad_nonfinite"]
        assert v["grad_norm"] > 1e4 and jv["grad_spike"]
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5)
    assert int(np.asarray(opt._state["step"])) == 3
    assert len({tuple(r["losses"]) for r in port}) == 1


def test_one_rank_faults_take_one_verdict(state_files):
    """Every rank takes the verdict of the reduced loss: a loss spike on
    rank 0 alone fails a factor of 20 and passes one of 40 on both ranks;
    a NaN gradient on the last rank skips both; the weights stay equal
    over the ranks."""
    tmp, sp, tp = state_files
    port = run_ranks("sentry_agree", 2, {"state_path": sp, "table_path": tp},
                     tmp, timeout=150.0)
    for r in port:
        kinds = [(v["anomaly"], v["loss_spike"], v["grad_nonfinite"])
                 for v in r["verdicts"]]
        assert kinds == [(True, True, False), (False, False, False),
                         (True, False, True)], kinds
        assert r["step_counter"] == 5.0
    assert repr(port[0]["verdicts"]) == repr(port[1]["verdicts"])
    for k, v in port[0]["weights"].items():
        assert np.array_equal(v, port[1]["weights"][k]), k


# ---------------------------------------------------------------------------
# checkpoint generations (tests/test_resilience.py:246-429)
# ---------------------------------------------------------------------------

def _ck_pair(state):
    """A port model and optimizer trained one step (batch 2)."""
    p = _Port(state, sentry=False)
    p.step(0)
    return p


def test_generation_verify_detects_corruption_and_staleness(state, tmp_path):
    p = _ck_pair(state)
    root = str(tmp_path / "gens")
    d1 = pres.save_generation(p.model, p.opt, root, step=1, keep=4)
    ok, problems = pres.verify_generation(d1)
    assert ok, problems
    stale = os.path.join(d1, "model_00099-of-00100.safetensors")
    with open(stale, "wb") as f:
        f.write(b"junk")
    ok, problems = pres.verify_generation(d1)
    assert not ok and any("unmanifested" in x for x in problems)
    os.remove(stale)
    assert pres.verify_generation(d1)[0]
    pres.corrupt_generation(root, step=1)
    ok, problems = pres.verify_generation(d1)
    assert not ok and any("digest mismatch" in x for x in problems)


def test_corruption_flips_jax_s_bytes(state, tmp_path):
    """``corrupt_generation`` flips the bytes JAX's flips (same seed):
    the same file corrupts to the same bytes in both packages."""
    p = _ck_pair(state)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    pres.save_generation(p.model, p.opt, a, step=3)
    pres.save_generation(p.model, p.opt, b, step=3)
    pa = pres.corrupt_generation(a, seed=9)
    pb = jres.corrupt_generation(b, seed=9)
    with open(pa, "rb") as fa, open(pb, "rb") as fb:
        assert fa.read() == fb.read()


def test_restore_falls_back_past_corrupted_generation(state, tmp_path):
    p = _ck_pair(state)
    root = str(tmp_path / "gens")
    pres.save_generation(p.model, p.opt, root, step=1, keep=4)
    want = p.params()
    p.step(1)
    pres.save_generation(p.model, p.opt, root, step=2, keep=4)
    pres.corrupt_generation(root)
    info = pres.load_latest_generation(p.model, p.opt, root)
    assert info["generation"] == 1
    assert [f["generation"] for f in info["fallbacks"]] == [2]
    assert _bitwise(want, p.params())
    assert pckpt.restore_records(root)[-1]["verified"]


def test_kill_mid_write_previous_generation_survives(state, tmp_path):
    p = _ck_pair(state)
    root = str(tmp_path / "gens")
    pres.save_generation(p.model, p.opt, root, step=1, keep=4)
    want = p.params()
    p.step(1)
    pckpt.arm_kill_mid_write(after_files=1)
    try:
        with pytest.raises(pckpt.WriterDeathError):
            pres.save_generation(p.model, p.opt, root, step=2, keep=4)
    finally:
        pckpt.disarm_kill_mid_write()
    d2 = os.path.join(root, "gen-2")
    assert os.path.isdir(d2)
    assert not os.path.exists(os.path.join(d2, "manifest.json"))
    ok, problems = pres.verify_generation(d2)
    assert not ok and "no manifest" in problems[0]
    info = pres.load_latest_generation(p.model, p.opt, root)
    assert info["generation"] == 1
    assert [f["generation"] for f in info["fallbacks"]] == [2]
    assert _bitwise(want, p.params())


def test_resave_same_step_death_keeps_committed_generation(state, tmp_path):
    p = _ck_pair(state)
    root = str(tmp_path / "gens")
    pres.save_generation(p.model, p.opt, root, step=1, keep=4)
    want = p.params()
    p.step(1)
    pckpt.arm_kill_mid_write(after_files=1)
    try:
        with pytest.raises(pckpt.WriterDeathError):
            pres.save_generation(p.model, p.opt, root, step=1, keep=4)
    finally:
        pckpt.disarm_kill_mid_write()
    d1 = os.path.join(root, "gen-1")
    assert pres.verify_generation(d1)[0]
    info = pres.load_latest_generation(p.model, p.opt, root)
    assert info["generation"] == 1 and not info["fallbacks"]
    assert _bitwise(want, p.params())
    p.step(2)
    pres.save_generation(p.model, p.opt, root, step=1, keep=4)
    assert pres.verify_generation(d1)[0]
    assert not os.path.exists(d1 + ".prev")


def test_generation_retention_prunes_committed_only(state, tmp_path):
    p = _ck_pair(state)
    root = str(tmp_path / "gens")
    for s in (1, 2, 3, 4):
        pres.save_generation(p.model, p.opt, root, step=s, keep=2)
    assert pres.list_generations(root) == [3, 4]
    assert pres.prune_generations(root, 1) == [4]


def test_resave_fewer_shards_drops_stale_files(tmp_path):
    d = str(tmp_path / "ck")
    a = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
         "b": torch.ones(8)}
    pckpt.save_split(a, d, num_shards=4)
    assert len([f for f in os.listdir(d) if f.endswith(".safetensors")]) \
        == 4
    b = {"w": -a["w"], "b": 3 * a["b"]}
    pckpt.save_split(b, d, num_shards=2)
    assert len([f for f in os.listdir(d) if f.endswith(".safetensors")]) \
        == 2
    back = pckpt.load_split(d)
    for k in b:
        assert torch.equal(back[k], b[k])


def test_generations_cross_both_ways(state, tmp_path):
    """A generation JAX's ``save_generation`` writes verifies and
    restores in the port, and the port's in JAX; the next step agrees
    within 1e-5, so the optimizer state crossed too."""
    p, j = _Port(state, sentry=False), _Jax(state, sentry=False)
    for m in (p, j):
        m.step(0)
        m.step(1)
    jroot, proot = str(tmp_path / "j"), str(tmp_path / "p")
    jres.save_generation(j.model, j.opt, jroot, step=2)
    pres.save_generation(p.model, p.opt, proot, step=2)
    assert pres.verify_generation(pres.generation_dir(jroot, 2))[0]
    assert jres.verify_generation(jres.generation_dir(proot, 2))[0]
    p2, j2 = _Port(state, sentry=False), _Jax(state, sentry=False)
    assert pres.load_latest_generation(p2.model, p2.opt, jroot)[
        "generation"] == 2
    assert jres.load_latest_generation(j2.model, j2.opt, proot)[
        "generation"] == 2
    for k, v in j.model.state_dict().items():
        np.testing.assert_array_equal(
            p2.model.state_dict()[k].numpy(), np.asarray(v), err_msg=k)
    np.testing.assert_allclose(p2.step(2), j.step(2), rtol=1e-5)
    np.testing.assert_allclose(j2.step(2), p.step(2), rtol=1e-5)


# ---------------------------------------------------------------------------
# the background save from several processes
# ---------------------------------------------------------------------------

def test_background_save_from_ranks(state, state_files):
    """4 ranks save in the background after 2 steps and train a third
    while the writer threads meet at the coordinator's barriers; the
    checkpoint holds the weights of the save, and JAX loads it.  Without
    a coordinator the save is refused."""
    tmp, sp, tp = state_files
    jobs = [("bg_save", {"state_path": sp, "table_path": tp,
                         "out_dir": str(tmp / "bg"), "coordinator": True}),
            ("bg_save", {"state_path": sp, "table_path": tp,
                         "out_dir": str(tmp / "bg_refused"),
                         "coordinator": False})]
    port = run_ranks("many", 4, {"jobs": jobs}, tmp, timeout=150.0)
    assert all(r[0]["error"] is None for r in port)
    want = port[0][0]["weights"]
    # dp replicates every slice: rank 0 writes them, the merge keeps the
    # files its index names
    files = set(os.listdir(tmp / "bg"))
    assert {"index.json", "trainer_state.json",
            "model_00000-of-00004.safetensors"} <= files
    back = pckpt.load_split(str(tmp / "bg"))
    for k, v in want.items():
        assert np.array_equal(back[k].numpy(), v), k
    j = _Jax(state, sentry=False)
    assert jckpt.load_checkpoint(j.model, j.opt, str(tmp / "bg"),
                                 verify_exempt=True)["step"] == 2
    jw = {k: np.asarray(v) for k, v in j.model.state_dict().items()}
    for k, v in want.items():
        assert np.array_equal(jw[k], v), k
    for r in port:
        assert "CoordinatorClient" in r[1]["error"]
