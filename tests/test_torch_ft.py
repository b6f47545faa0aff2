"""The port's fault-tolerant trainer against the JAX package's, on the CPU.

``FaultTolerantTrainer`` on 4 gloo ranks (tests/torch_ranks.py, one
``WorkerMonitor`` worker a rank) against the JAX package's on 4 CPU
devices, on the tiny GPT of tests/test_torch_resilience.py (2 layers,
fp32, one JAX state) under flat ZeRO-2 with the sentry, 16 steps, a
generation every 4, two kept, and the fault plan of the smoke's phase 27
(b): ``grad_nan`` at step 3 (skipped), ``loss_spike`` at 6 (rewound),
``shard_corrupt`` at 9 (the restore falls back past it), the death of
rank 3 at 10 (recovered on dp 2: 3 survivors, one idles) and
``kill_mid_write`` at 11 (the generation of step 12 dies; the earlier
ones survive).  The counters, the burned and committed cursors, the
recoveries and their dp equal JAX's; the committed losses are within
1e-5 of JAX's; every rank returns the same run; the losses before the
death equal a fault-free run of the same layout on the same cursors
bitwise, and all are within 1e-4 of it.  The emergency flush likewise.
"""
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import hetu_tpu as jht
from hetu_tpu import elastic as jel
from hetu_tpu import optim as joptim
from hetu_tpu.fault import FaultEvent, FaultPlan
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPTLMHeadModel
from hetu_tpu.obs.tracer import SpanTracer, install_tracer
from hetu_tpu_torch import elastic as pel
from torch_ranks import FT_CFG, run_ranks

TABLE = np.random.RandomState(42).randint(0, 64, (64, 8, 16)) \
    .astype(np.int32)
STEPS = 16
PLAN = [(3, "grad_nan", 0), (6, "loss_spike", 0), (9, "shard_corrupt", 0),
        (10, "worker_death", 3), (11, "kill_mid_write", 0)]
TRAINER_KW = {"checkpoint_every": 4, "keep_checkpoints": 2}
FLUSH_PLAN = [(3, "worker_death", 2)]
FLUSH_STEPS = 6
FLUSH_KW = {"checkpoint_every": 4, "emergency_flush": True}


def _jax_state():
    jht.set_seed(3)
    with jht.graph("eager", create_new=True):
        model = JaxGPTLMHeadModel(JaxGPTConfig(**FT_CFG))
        model.logits(np.zeros((1, 4), np.int32))
        return {k: np.asarray(v) for k, v in model.state_dict().items()}


def _jax_build_fn(state):
    def build(dp, devices):
        mesh = jht.create_mesh({"dp": dp}, devices[:dp])
        gctx = jht.graph("define_and_run", create_new=True, mesh=mesh)
        g = gctx.__enter__()
        ids = jht.parallel_placeholder("int32", (8, 16), pspec=JP("dp", None),
                                       name="ids")
        labels = jht.parallel_placeholder("int32", (8, 16),
                                          pspec=JP("dp", None), name="labels")
        model = JaxGPTLMHeadModel(JaxGPTConfig(**FT_CFG))
        loss = model(ids, labels)
        opt = joptim.AdamOptimizer(lr=1e-2, zero=2, grad_comm="fp32",
                                   flat_state=True, sentry=True)
        op = opt.minimize(loss)
        model.load_state_dict(state)

        def step_fn(c):
            b = TABLE[c]
            out = g.run(loss, [loss, op], {ids: b, labels: np.roll(b, -1, 1)})
            return float(np.asarray(out[0]))

        return jel.TrainBuild(graph=g, model=model, optimizer=opt,
                              step_fn=step_fn,
                              close=lambda: gctx.__exit__(None, None, None))
    return build


def _jax_run(devices, state, ckdir, events, steps, kw):
    mon = jel.WorkerMonitor(4, devices, ttl=0.5, heartbeat_interval=0.05)
    tracer = SpanTracer()
    install_tracer(tracer)
    try:
        tr = jel.FaultTolerantTrainer(_jax_build_fn(state), devices,
                                      monitor=mon, checkpoint_dir=ckdir,
                                      **kw)
        plan = FaultPlan(events=[FaultEvent(step=s, kind=k, target=t)
                                 for s, k, t in events])
        losses = tr.train(steps, fault_plan=plan)
    finally:
        install_tracer(None)
        mon.close()
    out = {"losses": losses, "metrics": tr.metrics_summary(),
           "recoveries": [{k: v for k, v in r.items()
                           if not k.endswith("_s") and k not in
                           ("killed_at", "_t0")} for r in tr.recoveries],
           "cursors": tr.committed_cursors(),
           "burned": list(tr.burned_cursors), "dp": tr.dp,
           "ck_steps": list(tr._ck_steps)}
    tr.close()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("ft")
    state = _jax_state()
    np.savez(tmp / "state.npz", **state)
    np.save(tmp / "table.npy", TABLE)
    common = {"state_path": str(tmp / "state.npz"),
              "table_path": str(tmp / "table.npy")}
    jobs = [("ft", {**common, "ckdir": str(tmp / "port_ck"),
                    "events": PLAN, "steps": STEPS,
                    "trainer_kw": TRAINER_KW}),
            ("ft", {**common, "ckdir": str(tmp / "port_flush"),
                    "events": FLUSH_PLAN, "steps": FLUSH_STEPS,
                    "trainer_kw": FLUSH_KW})]
    port = run_ranks("many", 4, {"jobs": jobs}, tmp, timeout=240.0)
    jax = [_jax_run(devices8[:4], state, str(tmp / "jax_ck"), PLAN, STEPS,
                    TRAINER_KW),
           _jax_run(devices8[:4], state, str(tmp / "jax_flush"), FLUSH_PLAN,
                    FLUSH_STEPS, FLUSH_KW)]
    return port, jax


COMPARED = ("metrics", "recoveries", "cursors", "burned", "dp", "ck_steps")


@pytest.mark.parametrize("job", [0, 1], ids=["ladder_and_death", "flush"])
def test_trainer_matches_jax(runs, job):
    port, jax = runs
    got, want = port[0][job], jax[job]
    for key in COMPARED:
        assert got[key] == want[key], (key, got[key], want[key])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)


def test_plan_counters(runs):
    """The plan's faults each land as the ladder says, on every rank."""
    port, _ = runs
    m = port[0][0]["metrics"]
    assert {k: m[k] for k in ("sentry_anomalies", "steps_skipped",
                              "rewinds", "restore_fallbacks",
                              "worker_recoveries",
                              "checkpoint_write_failures",
                              "emergency_flushes")} == {
        "sentry_anomalies": 2, "steps_skipped": 2, "rewinds": 1,
        "restore_fallbacks": 1, "worker_recoveries": 1,
        "checkpoint_write_failures": 1, "emergency_flushes": 0}
    rewind, death = port[0][0]["recoveries"]
    assert rewind["kind"] == "numeric_rewind" and \
        rewind["reason"] == "loss_spike"
    assert death["kind"] == "worker_death" and death["dp"] == 2 and \
        death["devices"] == 3 and death["resumed_from_step"] == 4
    assert all(t is not None and t > 0 for t in port[0][0]["mttr"])
    text = port[0][0]["metrics_text"]
    for name in pel.TRAINER_COUNTERS:
        assert f"trainer_{name}" in text
    report = port[0][0]["report"]
    assert report["metrics"] == m and report["final_dp"] == 2
    assert report["checkpoints"] == [4, 8]
    assert [r["kind"] for r in report["recoveries"]] == \
        ["numeric_rewind", "worker_death"]


def test_every_rank_takes_the_same_run(runs):
    port, _ = runs
    for job in (0, 1):
        first = port[0][job]
        for r in port[1:]:
            for key in COMPARED + ("losses", "attempts"):
                assert r[job][key] == first[key], (job, key)
    # dp 2 over the survivors 0, 1, 2: rank 2 idles, rank 3 is "dead"
    assert [r[0]["in_mesh"] for r in port] == [True, True, False, False]
    # the sentry's verdict rode one host read an attempt on the mesh
    assert port[0][0]["host_reads"] <= port[0][0]["attempts"]


def test_committed_losses_against_a_fault_free_run(runs):
    """Steps 0-3 (never rewound past the death's restore) equal the
    fault-free dp-4 run bitwise; the steps after the recovery, at dp 2,
    within 1e-4 of it."""
    port, _ = runs
    r = port[0][0]
    assert r["losses"][:4] == r["ref_losses"][:4]
    np.testing.assert_allclose(r["losses"], r["ref_losses"], rtol=1e-4)
    f = port[0][1]
    assert f["losses"][:3] == f["ref_losses"][:3]
    np.testing.assert_allclose(f["losses"], f["ref_losses"], rtol=1e-4)


def test_kill_mid_write_leaves_the_previous_generations(runs):
    port, _ = runs
    assert port[0][0]["generations"] == {4: True, 8: True, 12: False}
    assert port[0][0]["ck_steps"] == [4, 8]


def test_emergency_flush_shrinks_rewind_to_zero(runs):
    port, jax = runs
    rec = port[0][1]["recoveries"][0]
    assert rec["resumed_from_step"] == 3 and rec["rewound_steps"] == 0
    assert port[0][1]["metrics"]["emergency_flushes"] == 1
    assert jax[1]["recoveries"][0]["resumed_from_step"] == 3
