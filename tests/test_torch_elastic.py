"""The port's elastic engine (Malleus) against the JAX package, on the
CPU: the straggler profiler and the strategy solver (both numpy, the
port keeps its own copies) give the same ratios, plans, device orders,
stage layers, micro-batches and step-time estimates as
``hetu_tpu.elastic`` on every case of tests/test_elastic.py; the
``Trainer`` on 4 gloo ranks (tests/torch_ranks.py) takes the same switch
decisions, records the same strategies and trains the same losses
(within 2e-5) as the JAX ``Trainer`` on 4 CPU devices, from one JAX
state; and ``examples/train_malleus_torch.py`` passes its own gates on 4
gloo CPU ranks.

The JAX Trainer profiles a one-process program and reads every device as
healthy unless ratios are injected; the port merges real step times over
its ranks.  So where a JAX case relies on that default, both packages are
given the healthy ratios (``HETU_TPU_STRAGGLER_RATIOS``) instead.
"""
import os
import sys

import numpy as np
import pytest

import hetu_tpu as jht
from hetu_tpu import elastic as jel
from hetu_tpu import optim as joptim
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPTLMHeadModel

from hetu_tpu_torch import elastic as pel
from hetu_tpu_torch.elastic import strategy as pstrategy
from hetu_tpu.elastic import strategy as jstrategy
from torch_ranks import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plan_tuple(p):
    return (p.tp, p.pp, p.dp, list(p.device_order),
            [list(s) for s in p.stage_layers], list(p.micro_batches),
            p.est_step_time, list(p.tp_group_times), p.is_hetero,
            p.mesh_shape, p.describe())


# ---------------------------------------------------------------------------
# straggler and solver: numpy against numpy
# ---------------------------------------------------------------------------

def test_straggler_env_injection(monkeypatch):
    monkeypatch.setenv("HETU_TPU_STRAGGLER_RATIOS", "2.0,1.0,1.0,1.0")
    assert pel.Straggler(4).read_profile() == \
        jel.Straggler(4).read_profile() == [2.0, 1.0, 1.0, 1.0]


def test_straggler_workload_injection():
    got = []
    for mod in (pel, jel):
        s = mod.Straggler(4)
        s.inject(mod.StragglerWorkload([1.0, 1.0, 3.0, 1.0]))
        s.begin_profile()
        s.end_profile(steps=1)
        got.append(s.read_profile())
    assert got[0] == got[1]
    assert got[0][2] == pytest.approx(3.0) and min(got[0]) == 1.0


def test_straggler_healthy_default():
    assert pel.Straggler(8).read_profile() == \
        jel.Straggler(8).read_profile() == [1.0] * 8


def test_straggler_kv_missing_host_treated_slow():
    class FakeKV:
        def __init__(self):
            self.d = {"straggler/0": "1.0"}

        def put(self, k, v):
            self.d[k] = v

        def get(self, k, timeout=None):
            return self.d.get(k)

    got = []
    for mod in (pel, jel):
        s = mod.Straggler(4, kv_store=FakeKV(), host_id=0,
                          devices_per_host=2)
        s._seconds_per_step = 1.0
        with pytest.warns(UserWarning, match="missing"):
            got.append(s.read_profile())
    assert got[0] == got[1]
    assert got[0][2] > 5.0 and got[0][3] > 5.0 and got[0][0] == 1.0


def test_tp_grouping_quarantines_stragglers():
    ratios = [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0, 2.0]
    got = [mod.StrategyModel(num_devices=8, num_layers=8)
           .solve_tp_arrangements(ratios, tp=2) for mod in (pel, jel)]
    assert got[0] == got[1]
    groups, times = got[0]
    assert len([g for g in groups if 6 in g or 7 in g]) == 1
    assert sorted(times) == [1.0, 1.0, 1.0, 2.0]


@pytest.mark.parametrize("layers,times", [(12, [1.0, 2.0]), (8, [1.0]),
                                          (9, [1.5, 1.0, 3.0])])
def test_layer_partition(layers, times):
    got = pstrategy._partition_layers(layers, times)
    assert got == jstrategy._partition_layers(layers, times)
    assert sum(got[0]) == layers


@pytest.mark.parametrize("total,weights", [(8, [1.0, 1.0]), (9, [2.0, 1.0]),
                                           (7, [1.0, 3.0, 0.5])])
def test_micro_batch_apportionment(total, weights):
    got = pstrategy._apportion(total, weights)
    assert got == jstrategy._apportion(total, weights)
    assert sum(got) == total


SOLVES = {
    "homogeneous": (dict(num_devices=8, num_layers=8, num_micro_batches=4),
                    [1.0] * 8, 0),
    "straggler_pair": (dict(num_devices=8, num_layers=8,
                            num_micro_batches=4, tp_candidates=[2],
                            pp_candidates=[2]),
                       [1.0] * 6 + [3.0, 3.0], 1),
    "assignment_search": (dict(num_devices=8, num_layers=8,
                               num_micro_batches=8, tp_candidates=[1],
                               pp_candidates=[2]),
                          [1.0] * 6 + [2.0, 4.0], 1),
    "four_ranks_straggler": (dict(num_devices=4, num_layers=4),
                             [3.0, 1.0, 1.0, 1.0], 0),
    "four_ranks_pair": (dict(num_devices=4, num_layers=2,
                             num_micro_batches=2, tp_candidates=[1, 2, 4],
                             pp_candidates=[1]),
                        [1.0, 1.0, 4.0, 4.0], 0),
}


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_make_plans_equal_jax(case):
    kw, ratios, top_k = SOLVES[case]
    got = [[_plan_tuple(p) for p in mod.StrategyModel(**kw)
            .make_plans(ratios, top_k=top_k)] for mod in (pel, jel)]
    assert got[0] == got[1] and got[0]
    best = pel.StrategyModel(**kw).make_plans(ratios, top_k=1)[0]
    assert pel.StrategyModel(**kw).estimate(best, ratios) == \
        jel.StrategyModel(**kw).estimate(best, ratios)


def test_make_plans_keep_the_jax_cases_properties():
    m = pel.StrategyModel(num_devices=8, num_layers=8, num_micro_batches=4)
    best = m.make_plans([1.0] * 8, top_k=0)[0]
    assert best.tp == 1 and best.pp == 1 and best.dp == 8
    kw, ratios, _ = SOLVES["straggler_pair"]
    (plan,) = pel.StrategyModel(**kw).make_plans(ratios, top_k=1)
    assert plan.tp == 2 and plan.pp == 2 and plan.dp == 2
    assert sorted(plan.device_order) == list(range(8))
    kw, ratios, _ = SOLVES["assignment_search"]
    m = pel.StrategyModel(**kw)
    (plan,) = m.make_plans(ratios, top_k=1)
    groups, gtimes = m.solve_tp_arrangements(ratios, 1)
    order = sorted(range(len(groups)), key=lambda g: gtimes[g])
    rr = [[] for _ in range(4)]
    for i, g in enumerate(order):
        rr[i % 4].append(g)
    _, _, _, rr_step = m._eval_assignment(rr, gtimes, tp=1, pp=2, dp=4)
    assert plan.est_step_time < rr_step - 1e-6
    assert min(plan.micro_batches) < max(plan.micro_batches)


def test_strategy_is_hetero_and_mesh_shape():
    for kw in (dict(stage_layers=[[4, 4], [4, 4]], micro_batches=[2, 2]),
               dict(stage_layers=[[4, 4], [4, 4]], micro_batches=[3, 1]),
               dict(stage_layers=[[5, 3], [4, 4]], micro_batches=[2, 2])):
        s = [mod.Strategy(tp=2, pp=2, dp=2, device_order=list(range(8)),
                          est_step_time=1.0, **kw) for mod in (pel, jel)]
        assert _plan_tuple(s[0]) == _plan_tuple(s[1])
    assert pel.Strategy(tp=1, pp=1, dp=8, device_order=list(range(8)),
                        stage_layers=[[8]] * 8, micro_batches=[1] * 8,
                        est_step_time=1.0).mesh_shape == \
        {"pp": 1, "dp": 8, "tp": 1}


def test_trainer_hetero_error_policy():
    """hetero='error' refuses to project a hetero plan onto a rectangular
    mesh, naming ElasticMPMDTrainer and its ROADMAP item."""
    trainer = pel.Trainer.__new__(pel.Trainer)
    trainer.hetero = "error"
    trainer.devices = list(range(8))
    trainer.graph = type("G", (), {"mesh": None})()
    hetero = pel.Strategy(tp=1, pp=2, dp=4, device_order=list(range(8)),
                          stage_layers=[[5, 3], [4, 4], [4, 4], [4, 4]],
                          micro_batches=[1, 1, 1, 1], est_step_time=1.0)
    with pytest.raises(RuntimeError, match="ElasticMPMDTrainer.*11b"):
        trainer._apply_strategy(hetero)
    with pytest.raises(ValueError, match="hetero"):
        pel.Trainer(graph=None, loss=None, train_op=None, optimizer=None,
                    data_provider=None, solver=None, hetero="bogus")


@pytest.mark.parametrize("name,item", [
    ("FaultTolerantTrainer", "item 15"), ("TrainBuild", "item 15"),
    ("WorkerMonitor", "item 15"), ("ElasticMPMDTrainer", "item 11b")])
def test_unported_trainers_name_their_item(name, item):
    """``ElasticMPMDTrainer`` still names its item; the fault plane of
    item 15 is ported (tests/test_torch_ft.py): exported beside the JAX
    package's names."""
    if item == "item 15":
        assert name in pel.__all__ and name in jel.__all__
        assert getattr(pel, name) is getattr(pel.ft, name)
        return
    with pytest.raises(NotImplementedError, match=item):
        getattr(pel, name)
    assert name not in pel.__all__


# ---------------------------------------------------------------------------
# the Trainer: 4 gloo ranks against 4 JAX CPU devices
# ---------------------------------------------------------------------------

HEALTHY = "1.0,1.0,1.0,1.0"
TRAINER_JOBS = [
    # tests/test_elastic.py:231: a straggler pair makes the solver
    # quarantine it and the trainer switch (a permuted mesh)
    ("elastic_switch", {"dp": 2, "tp": 2},
     dict(num_layers=2, num_micro_batches=2, tp_candidates=[1, 2, 4],
          pp_candidates=[1]),
     [("train", 3), ("env", "1.0,1.0,4.0,4.0"), ("retune", None),
      ("train", 3)]),
    # :254: healthy ratios; the first retune adopts the plan, the second
    # is a no-op
    ("no_switch_when_healthy", {"dp": 4},
     dict(num_layers=2, num_micro_batches=2, tp_candidates=[1, 2],
          pp_candidates=[1]),
     [("train", 1), ("retune", [1.0] * 4), ("retune", [1.0] * 4)]),
    # :270: run() profiles and retunes every 3 steps
    ("run_with_profile_interval", {"dp": 4},
     dict(num_layers=2, num_micro_batches=2, tp_candidates=[1],
          pp_candidates=[1]),
     [("env", HEALTHY), ("run", 6, 3)]),
    # :153: tp 2 -> dp only -> tp 2 again keeps the tp sharding
    ("dp_only_and_back", {"pp": 1, "dp": 2, "tp": 2},
     dict(num_layers=2, num_micro_batches=2, tp_candidates=[1, 2],
          pp_candidates=[1]),
     [("train", 1), ("tp_sharded",), ("retune", [1.0] * 4), ("train", 1),
      ("tp_sharded",), ("retune_tp2", [1.0, 1.0, 5.0, 5.0]), ("train", 1),
      ("tp_sharded",)]),
]


def _jax_state():
    jht.set_seed(3)
    with jht.graph("eager", create_new=True):
        model = JaxGPTLMHeadModel(JaxGPTConfig(
            vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=16, dtype="float32"))
        model.logits(np.zeros((1, 4), np.int32))
        return {k: np.asarray(v) for k, v in model.state_dict().items()}


def _jax_job(devices, state, shape, solver_kw, script, batch=8, seq=16):
    """The JAX package's Trainer on the same job (tests/test_elastic.py's
    ``_build_training``, the weights loaded from ``state``)."""
    from jax.sharding import PartitionSpec as JP
    mesh = jht.create_mesh(shape, devices)
    with jht.graph("define_and_run", create_new=True, mesh=mesh) as g:
        ids = jht.parallel_placeholder("int32", (batch, seq),
                                       pspec=JP("dp", None), name="ids")
        labels = jht.parallel_placeholder("int32", (batch, seq),
                                          pspec=JP("dp", None),
                                          name="labels")
        model = JaxGPTLMHeadModel(JaxGPTConfig(
            vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=seq, dtype="float32"))
        loss = model(ids, labels)
        opt = joptim.AdamOptimizer(lr=1e-2)
        train_op = opt.minimize(loss)
        model.load_state_dict(state)
    IDS = np.random.RandomState(0).randint(0, 64, (batch, seq)).astype(
        np.int32)
    feed = {ids: IDS, labels: np.roll(IDS, -1, 1)}
    trainer = jel.Trainer(g, loss, train_op, opt, lambda step: feed,
                          jel.StrategyModel(num_devices=len(devices),
                                            **solver_kw),
                          num_micro_batches=2)
    got = []
    for op in script:
        if op[0] == "train":
            got.append(trainer.train_steps(op[1]))
        elif op[0] == "retune":
            got.append(trainer.retune(op[1]))
        elif op[0] == "tp_candidates":
            trainer.solver.tp_candidates = op[1]
        elif op[0] == "env":
            os.environ["HETU_TPU_STRAGGLER_RATIOS"] = op[1]
        elif op[0] == "run":
            got.append(trainer.run(op[1], profile_interval=op[2]))
        elif op[0] == "tp_sharded":
            # a parameter split over a tp axis of more than one device
            got.append(dict(g.mesh.shape).get("tp", 1) > 1 and any(
                "tp" in ((e,) if isinstance(e, str) else (e or ()))
                for a in g._var_data.values()
                for e in (a.sharding.spec or [])))
    os.environ.pop("HETU_TPU_STRAGGLER_RATIOS", None)
    return {"got": got, "history": [h["strategy"] for h in trainer.history],
            "strategy": trainer.current_strategy.describe()
            if trainer.current_strategy else None}


def _script(script):
    """``retune_tp2`` forces tp 2 back (tests/test_elastic.py:172): the
    solver's candidates change first."""
    out = []
    for op in script:
        if op[0] == "retune_tp2":
            out += [("tp_candidates", [2]), ("retune", op[1])]
        else:
            out.append(op)
    return out


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("elastic")
    state = _jax_state()
    np.savez(tmp / "state.npz", **state)
    jobs = [(n, shape, kw, _script(s)) for n, shape, kw, s in TRAINER_JOBS]
    port = run_ranks("elastic", 4, {"state_path": str(tmp / "state.npz"),
                                    "jobs": jobs}, tmp, timeout=240.0)
    jax = {}
    for n, shape, kw, script in jobs:
        jax[n] = _jax_job(devices8[:4], state, shape, kw, script)
    return port, jax


@pytest.mark.parametrize("job", [j[0] for j in TRAINER_JOBS])
def test_trainer_matches_jax(trainer_runs, job):
    port, jax = trainer_runs
    want = jax[job]
    for r in port:
        got = r[job]
        assert got["history"] == want["history"]
        assert got["strategy"] == want["strategy"]
        assert len(got["got"]) == len(want["got"])
        for a, b in zip(got["got"], want["got"]):
            if isinstance(b, list):
                np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
            else:
                assert a == b
    if job == "elastic_switch":
        assert want["got"][1] is True
        assert port[0][job]["history"]
    if job == "no_switch_when_healthy":
        assert want["got"][2] is False
    if job == "dp_only_and_back":
        assert want["got"][1] and not want["got"][4] and want["got"][7]


def test_train_malleus_entry_passes_its_gates(monkeypatch):
    """``examples/train_malleus_torch.py`` at the JAX script's defaults on
    4 gloo CPU ranks from the launcher: the straggler is measured, the
    plan switches, and the gates hold (they raise in the ranks)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import train_malleus_torch as entry
    finally:
        sys.path.pop(0)
    out = entry.main(["--device", "cpu", "--launch-timeout", "240"])
    assert out["ratios"] == [3.0, 1.0, 1.0, 1.0]
    assert out["switched"] and out["history"]
    assert out["num_strategy"] == 2
    assert out["post"][0] <= out["pre"][-1] + 0.1 * abs(out["pre"][-1])
    assert (out["pre"] + out["post"])[-1] < out["pre"][0]
    with pytest.raises(NotImplementedError, match="item 16"):
        entry.main(["--calibrate"])
