"""Hot switching in the port (``parallel.switch``, ``DefineAndRunGraph.
switch_strategy``) against the JAX package, on the CPU.

- ``SwitchPlan`` is computed from shapes, specs, mesh shapes and rank
  lists alone, so it is held in one process against the JAX package's
  plan on the ``devices8`` fixture (a device's id is a rank): the same
  transfers (destination, source, global box), local and moved bytes, on
  tests/test_switch.py's cases and on subset and permuted meshes.  A
  fused QKV weight is block-sharded in the port and contiguous in
  GSPMD's view, so there the bytes each (destination, source) pair moves
  are compared.
- ``switch_state`` keeps values across dp <-> dp x tp, ZeRO chunks, fused
  blocks (the kv heads repeated over tp too), subset and permuted meshes,
  and casts on the way (``TRANSFER_PARAM``), on 4 gloo ranks
  (tests/torch_ranks.py).
- Trajectories: a tiny GPT-2 from one JAX state trains on 4 gloo ranks
  and switches ``{"dp": 4}`` -> ``{"dp": 2, "tp": 2}`` (per-parameter
  Adam, Adafactor with momentum, whose statistics are taken over whole
  parameters) or ``{"dp": 4}`` -> ``{"dp": 2}`` on ranks [2, 3] (flat
  ZeRO-2 and ZeRO-3, whose flat state takes no tp), and the JAX package
  runs the same switches on 4 of its CPU devices: losses and final weights
  within 2e-5.  The batch ignores no label: with ignored labels spread
  unevenly over the dp shards, the JAX package's explicit grad-comm (flat)
  step reports a first loss, before any update or switch, 7.5e-4 away
  from its per-parameter step's on the same batch, a reduction of that
  path that the port's steps do not share.
- The JAX tests' invariants inside the port: switched equals unswitched,
  a missing axis is dropped and stays dropped, the optimizer modes need an
  optimizer, pending gradient sums follow the parameters, a rank outside
  the new mesh holds nothing, and a size-1 mesh switched onto itself
  trains bitwise as before.
"""
import numpy as np
import pytest

import hetu_tpu as jht
from hetu_tpu import optim as joptim
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPTLMHeadModel
from hetu_tpu.parallel import SwitchPlan as JaxSwitchPlan
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import hetu_tpu_torch as ht
from hetu_tpu_torch import optim
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
from hetu_tpu_torch.parallel import P, create_mesh
from hetu_tpu_torch.parallel.switch import (Layout, SwitchMode, SwitchPlan,
                                            SwitchProfile,
                                            symbolic_repack_transfers)
from torch_ranks import run_ranks

# ---------------------------------------------------------------------------
# SwitchPlan against the JAX package's
# ---------------------------------------------------------------------------

# (shape, src (axes, ranks, spec), dst (axes, ranks, spec))
PLANS = {
    "split_to_replicated": ((8, 4), ({"dp": 8}, range(8), ("dp", None)),
                            ({"dp": 8}, range(8), (None, None))),
    "resharding": ((8, 8), ({"dp": 4, "tp": 2}, range(8), ("dp", "tp")),
                   ({"dp": 4, "tp": 2}, range(8), ("tp", "dp"))),
    "identity": ((8, 8), ({"dp": 4, "tp": 2}, range(8), ("dp", "tp")),
                 ({"dp": 4, "tp": 2}, range(8), ("dp", "tp"))),
    "dp8_to_dp2_tp4": ((16, 8), ({"dp": 8}, range(8), ("dp", None)),
                       ({"dp": 2, "tp": 4}, range(8), (None, "tp"))),
    "dp8_to_dp4_subset": ((16, 8), ({"dp": 8}, range(8), ("dp", None)),
                          ({"dp": 4}, [4, 5, 6, 7], ("dp", None))),
    "permuted_tp": ((8, 12), ({"dp": 2, "tp": 2}, range(4), (None, "tp")),
                    ({"dp": 2, "tp": 2}, [3, 1, 2, 0], ("tp", None))),
    "grow_from_subset": ((12, 4), ({"dp": 2}, [5, 2], ("dp", None)),
                         ({"dp": 2, "tp": 2}, range(4), ("dp", "tp"))),
}


def _jax_plan(devices, shape, src, dst):
    def sharding(axes, ranks, spec):
        devs = np.array([devices[r] for r in ranks]).reshape(
            tuple(axes.values()))
        return NamedSharding(JaxMesh(devs, tuple(axes)), JP(*spec))
    return JaxSwitchPlan(shape, 4, sharding(*src), sharding(*dst))


def _port_plan(shape, src, dst, **kw):
    def layout(axes, ranks, spec):
        return Layout(axes, list(ranks), P(*spec), **kw)
    return SwitchPlan(shape, 4, layout(*src), layout(*dst))


@pytest.mark.parametrize("case", sorted(PLANS))
def test_switch_plan_equals_jax(devices8, case):
    shape, src, dst = PLANS[case]
    j = _jax_plan(devices8, shape, src, dst)
    p = _port_plan(shape, src, dst)
    want = sorted((d.id, s.id, tuple(ov)) for d, s, ov in j.transfers)
    got = sorted((t.dst, t.src, t.box) for t in p.transfers)
    assert got == want
    assert (p.local_bytes, p.moved_bytes) == (j.local_bytes, j.moved_bytes)
    assert p.local_bytes + p.moved_bytes == \
        4 * int(np.prod(shape)) * len(list(dst[1])) // \
        int(np.prod([dst[0][a] for a in dst[0]
                     if a in {e for e in dst[2] if e}]))
    if case == "identity":
        assert p.moved_bytes == 0
    if case == "split_to_replicated":
        assert p.local_bytes == 8 * 4 * 4
        assert p.moved_bytes == 8 * 7 * 4 * 4


@pytest.mark.parametrize("dst", [
    ({"dp": 4, "tp": 2}, range(8), (None, None)),
    ({"dp": 4, "tp": 2}, range(8), ("tp", None)),
    ({"dp": 2, "tp": 4}, range(8), (None, None))])
def test_fused_qkv_plan_moves_the_bytes_jax_moves(devices8, dst):
    """A fused ``[q | k | v]`` weight under tp 2, to replicated or to the
    same tp: the port's block pieces move, pair by pair, the bytes the
    JAX package's contiguous shards move (a tp resize does not: the
    blocks are the point of the port's layout)."""
    shape = (96, 32)
    src = ({"dp": 4, "tp": 2}, range(8), ("tp", None))
    j = _jax_plan(devices8, shape, src, dst)
    p = _port_plan(shape, src, dst, blocks=(32, 32, 32))
    def by_pair(transfers):
        out = {}
        for d, s, box in transfers:
            n = int(np.prod([hi - lo for lo, hi in box]))
            out[(d, s)] = out.get((d, s), 0) + n
        return out
    assert by_pair((t.dst, t.src, t.box) for t in p.transfers) == \
        by_pair((d.id, s.id, ov) for d, s, ov in j.transfers)
    assert (p.local_bytes, p.moved_bytes) == (j.local_bytes, j.moved_bytes)
    assert len(p.transfers) == 3 * len(j.transfers)


def test_repack_transfers_cover_the_flat_buffer():
    numel = 37
    src = {r: (r * 10, r * 10 + 10) for r in range(4)}
    dst = {r: (r * 19, r * 19 + 19) for r in range(2)}
    t = symbolic_repack_transfers(numel, 4, src, dst)
    assert sum(n for *_, n in t) == numel * 4
    assert t == sorted(t) and all(lo < hi for _, _, (lo, hi), _ in t)


def test_chunked_layout_pieces():
    """A ZeRO chunk of a tp shard: the rank's dim-0 chunk over dp of its
    block pieces."""
    lay = Layout({"dp": 2, "tp": 2}, range(4), P("tp", None),
                 blocks=(8, 4, 4), units=(4, 2, 2), chunk_axis="dp")
    # tp rank 0 holds rows 0-3 of q, 8-9 of k and 12-13 of v (8 local
    # rows); its dp rank 1 (rank 2) keeps local rows 4-7: k's and v's
    assert lay.local_shape((16, 3), 2) == (4, 3)
    assert lay.pieces((16, 3), 2) == [(((8, 10), (0, 3)), ((0, 2), (0, 3))),
                                      (((12, 14), (0, 3)),
                                       ((2, 4), (0, 3)))]
    assert lay.pieces((16, 3), 0) == [(((0, 4), (0, 3)), ((0, 4), (0, 3)))]


def test_repeated_kv_blocks_pieces():
    """Two kv heads over tp 4: ranks 0-1 hold kv head 0, ranks 2-3 head 1,
    each with its own q head."""
    lay = Layout({"tp": 4}, range(4), P("tp", None), blocks=(16, 8, 8),
                 units=(4, 2, 2))
    assert lay.local_shape((32, 2), 3) == (12, 2)
    assert [g for g, _ in lay.pieces((32, 2), 3)] == [
        ((12, 16), (0, 2)), ((20, 24), (0, 2)), ((28, 32), (0, 2))]
    assert [g for g, _ in lay.pieces((32, 2), 0)][1:] == [
        ((16, 20), (0, 2)), ((24, 28), (0, 2))]


# ---------------------------------------------------------------------------
# switch_state on 4 gloo ranks
# ---------------------------------------------------------------------------

def _lay(shape, ranks, spec, blocks=None, units=None, chunk=None):
    return (shape, list(ranks), spec, blocks, units, chunk)


VALUE_JOBS = [
    ("dp_to_dp_tp", _lay({"dp": 4}, range(4), ("dp", None)),
     _lay({"dp": 2, "tp": 2}, range(4), (None, "tp")), None),
    ("dp_tp_to_dp", _lay({"dp": 2, "tp": 2}, range(4), ("tp", "dp")),
     _lay({"dp": 4}, range(4), ("dp", None)), None),
    ("to_subset_permuted", _lay({"dp": 2, "tp": 2}, range(4), (None, "tp")),
     _lay({"dp": 2}, [3, 1], ("dp", None)), None),
    ("from_subset", _lay({"dp": 2}, [2, 0], (None, "dp")),
     _lay({"tp": 4}, [1, 0, 3, 2], ("tp", None)), None),
    ("zero_chunks", _lay({"dp": 2, "tp": 2}, range(4), (None, "tp"),
                         chunk="dp"),
     _lay({"dp": 4}, [3, 2, 1, 0], (), chunk="dp"), None),
    ("fused_blocks_repeated", _lay({"dp": 4}, range(4), ("dp", None)),
     _lay({"tp": 4}, range(4), ("tp", None), blocks=(8, 4, 4),
          units=(4, 2, 2)), None),
    ("transfer_param_bf16", _lay({"dp": 4}, range(4), ("dp", None)),
     _lay({"dp": 2, "tp": 2}, range(4), ("tp", None)), "bfloat16"),
]


MESH_RANKS = [({"dp": 2, "tp": 2}, [3, 1, 2, 0]), ({"dp": 2}, [2, 0]),
              ({"tp": 4}, [1, 3, 0, 2])]


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """One 4-rank launch: switch_state's jobs and the meshes over chosen
    ranks."""
    x = np.arange(16 * 12, dtype=np.float32).reshape(16, 12) / 7.0
    return run_ranks("many", 4, {"jobs": [
        ("switch_values", {"x": x, "jobs": VALUE_JOBS}),
        ("mesh_ranks", {"layouts": MESH_RANKS})]},
        tmp_path_factory.mktemp("switch_values"), timeout=120.0)


@pytest.fixture(scope="module")
def values(launch):
    return [r[0] for r in launch]


@pytest.mark.parametrize("i", range(len(MESH_RANKS)))
def test_mesh_over_chosen_ranks(launch, i):
    """``create_mesh(shape, ranks=)``: rank ``ranks[p]`` at position ``p``,
    a rank outside holds no position; every collective takes its
    operands in the axis' order though a process group orders its ranks
    by number."""
    shape, ranks = MESH_RANKS[i]
    sizes = tuple(shape.values())
    for rank, r in enumerate(launch):
        row = r[1][i]
        if rank not in ranks:
            assert not row["in_mesh"] and row["position"] is None
            assert row["coords"] == {} and row["groups"] == {}
            continue
        pos = ranks.index(rank)
        assert row["position"] == pos
        assert row["coords"] == dict(zip(shape, (
            int(c) for c in np.unravel_index(pos, sizes))))
        for a, grp in row["groups"].items():
            n = shape[a]
            i_a = row["coords"][a]
            assert grp["ranks"][i_a] == rank
            assert grp["gather"] == [float(j) for j in range(n)]
            # rank j' sends i + 10 j' to index i: index i gets the sum
            # of them, and in all-to-all each in axis order
            assert grp["scatter"] == [float(n * i_a + 10 * sum(range(n)))]
            assert grp["a2a"] == [float(i_a + 10 * j) for j in range(n)]


@pytest.mark.parametrize("job", [j[0] for j in VALUE_JOBS])
def test_switch_state_keeps_values(values, job):
    dtype = dict((j[0], j[3]) for j in VALUE_JOBS)[job]
    held = 0
    for rank, r in enumerate(values):
        out = r[job]
        assert out["consumed"]
        if out["want"] is None:
            assert out["got"] is None
            continue
        held += 1
        want = out["want"]
        if dtype == "bfloat16":
            import torch
            want = torch.from_numpy(want).bfloat16().float().numpy()
            assert out["dtype"] == "torch.bfloat16"
        np.testing.assert_array_equal(out["got"], want)
        # every send is recorded under the switch tag
        sent = [rec for rec in out["records"] if rec[5] == "switch"]
        assert sum(rec[1] for rec in sent) == out["sent"]
    assert held == len(dict((j[0], j[2]) for j in VALUE_JOBS)[job][1])
    prof = values[0][job]["profile"]
    assert prof["num_tensors"] == 1 and prof["total_bytes"] == 16 * 12 * 4
    assert sum(r[job]["sent"] for r in values) == \
        sum(r[job]["recv"] for r in values)


# ---------------------------------------------------------------------------
# trajectories against the JAX package
# ---------------------------------------------------------------------------

B, S = 4, 16
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=64, dropout=0.0, position="learned",
           norm="layernorm", activation="gelu")
F2 = {"zero": 2, "grad_comm": "fp32", "flat_state": True}
F3 = {"zero": 3, "grad_comm": "fp32", "flat_state": True}
D4, D2T2 = {"dp": 4}, {"dp": 2, "tp": 2}
# name -> (sp, (optimizer, kwargs), phases: (steps, next mesh, ranks,
# a pending GRAD run before the switch))
RUNS = {
    "base": (True, ("adam", {}), [(6, None, None, False)]),
    "adam": (True, ("adam", {}), [(3, D2T2, None, False),
                                  (3, None, None, False)]),
    "chain": (True, ("adam", {"zero": 2}),
              [(2, D2T2, None, False), (2, {"dp": 2}, [2, 3], False),
               (2, None, None, False)]),
    "zero2_flat": (False, ("adam", F2), [(3, {"dp": 2}, [2, 3], False),
                                         (3, None, None, False)]),
    "zero3_flat": (False, ("adam", F3), [(3, {"dp": 2}, [2, 3], False),
                                         (3, None, None, False)]),
    "zero3": (True, ("adam", {"zero": 3}), [(3, D2T2, [3, 2, 1, 0], False),
                                            (3, None, None, False)]),
    "adafactor_base": (False, ("adafactor", {"momentum": 0.9}),
                       [(6, None, None, False)]),
    "adafactor": (False, ("adafactor", {"momentum": 0.9}),
                  [(3, D2T2, None, False), (3, None, None, False)]),
    "pending_base": (True, ("adam", {"zero": 1}),
                     [(3, None, None, True), (3, None, None, False)]),
    "pending": (True, ("adam", {"zero": 1}),
                [(3, D2T2, [3, 1, 2, 0], True), (3, None, None, False)]),
    "drop_axis": (True, ("adam", {}), [(2, D2T2, None, False),
                                       (2, D4, None, False),
                                       (2, None, None, False)]),
}
# the runs the JAX package repeats on 4 of its CPU devices
JAX_RUNS = ("base", "adam", "zero2_flat", "zero3_flat", "adafactor_base",
            "adafactor")


def _jax_state():
    jht.set_seed(7)
    with jht.graph("eager", create_new=True):
        model = JaxGPTLMHeadModel(JaxGPTConfig(**CFG))
        model.logits(np.zeros((1, 4), np.int32))
        return {k: np.asarray(v) for k, v in model.state_dict().items()}


def _batch():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 64, (B, S)).astype(np.int32)
    y = rng.randint(0, 64, (B, S)).astype(np.int32)
    return x, y


def _jax_mesh(devices, shape, ranks=None):
    ranks = list(range(int(np.prod(list(shape.values()))))) \
        if ranks is None else ranks
    devs = np.array([devices[r] for r in ranks]).reshape(
        tuple(shape.values()))
    return JaxMesh(devs, tuple(shape))


def _jax_run(devices, state, x, y, name):
    """The JAX package's run: the same model, optimizer and switches."""
    from hetu_tpu.models.generate import _Params as JParams
    sp, (oname, okw), phases = RUNS[name]
    mk = {"adam": joptim.AdamOptimizer,
          "adafactor": joptim.AdafactorOptimizer}[oname]
    mesh = _jax_mesh(devices, D4)
    with jht.graph("define_and_run", create_new=True, mesh=mesh) as g:
        ids = jht.parallel_placeholder("int32", (B, S), pspec=JP("dp", None))
        labels = jht.parallel_placeholder("int32", (B, S),
                                          pspec=JP("dp", None))
        model = JaxGPTLMHeadModel(JaxGPTConfig(**CFG, sp=sp))
        loss = model(ids, labels)
        opt = mk(lr=1e-3, **okw)
        op = opt.minimize(loss)
        model.load_state_dict(state)
    losses = []
    for steps, nxt, ranks, _ in phases:
        for _ in range(steps):
            losses.append(float(np.asarray(
                g.run(loss, [loss, op], {ids: x, labels: y})[0])))
        if nxt is not None:
            g.switch_strategy(_jax_mesh(devices, nxt, ranks), optimizer=opt)
    weights = {JParams._norm(k): np.asarray(v, np.float32)
               for k, v in model.state_dict().items()}
    return losses, weights


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("switch_runs")
    x, y = _batch()
    np.savez(tmp / "batch.npz", x=x, y=y)
    state = _jax_state()
    np.savez(tmp / "state.npz", **state)
    runs = [(n, D4, sp, opt, phases)
            for n, (sp, opt, phases) in RUNS.items()]
    port = run_ranks("switch", 4, dict(
        state_path=str(tmp / "state.npz"), batch_path=str(tmp / "batch.npz"),
        cfg_kw=CFG, runs=runs, micro=1), tmp, timeout=300.0)
    jax_runs = {n: _jax_run(devices8, state, x, y, n) for n in JAX_RUNS}
    return port, jax_runs


def _port(port, name):
    """Losses (the first rank that held each step) and the weights."""
    losses = [next(r[name]["losses"][i] for r in port
                   if r[name]["losses"][i] is not None)
              for i in range(len(port[0][name]["losses"]))]
    weights = next(r[name]["weights"] for r in port
                   if r[name]["weights"] is not None)
    return losses, weights


@pytest.mark.parametrize("name", ["adam", "zero2_flat", "zero3_flat",
                                  "adafactor"])
def test_switch_trajectory_matches_jax(trajectories, name):
    port, jax_runs = trajectories
    losses, weights = _port(port, name)
    jl, jw = jax_runs[name]
    np.testing.assert_allclose(losses, jl, rtol=0, atol=2e-5)
    assert set(weights) == set(jw)
    for k, v in jw.items():
        np.testing.assert_allclose(weights[k], v, rtol=0, atol=2e-5,
                                   err_msg=f"{name} {k}")
    assert losses[-1] < losses[0]
    for r in port:
        assert r[name]["num_strategy"] == 2


@pytest.mark.parametrize("name,base", [
    ("adam", "base"), ("chain", "base"), ("zero3", "base"),
    ("drop_axis", "base"), ("pending", "pending_base"),
    ("adafactor", "adafactor_base")])
def test_switched_equals_unswitched(trajectories, name, base):
    """A switch changes the layout and nothing else: the losses and the
    weights of the unswitched run (ZeRO chunks, permuted and subset
    meshes, a pending GRAD run's gradients carried over), and the JAX
    package's one-device run."""
    port, jax_runs = trajectories
    losses, weights = _port(port, name)
    bl, bw = _port(port, base)
    np.testing.assert_allclose(losses, bl, rtol=0, atol=2e-6)
    for k in bw:
        np.testing.assert_allclose(weights[k], bw[k], rtol=0, atol=5e-6,
                                   err_msg=f"{name} {k}")
    if base == "base":
        np.testing.assert_allclose(bl, jax_runs["base"][0], rtol=0,
                                   atol=2e-5)


def test_switch_profiles_and_records(trajectories):
    """``SwitchProfile`` keeps the JAX package's keys; a dp 4 -> dp 2 x tp
    2 switch moves nothing (every destination holds a part of its own
    replica), a switch onto a subset moves bytes, and every send is
    recorded under the ``switch`` tag; idle ranks hold no steps."""
    port, _ = trajectories
    for r in port:
        (p,) = r["adam"]["profiles"]
        assert set(p) == set(SwitchProfile().as_dict())
        assert p["moved_bytes"] == 0 and p["num_tensors"] > 0
        assert p["repack_bytes"] == 0
        flat = r["zero2_flat"]["profiles"][0]
        assert flat["repack_bytes"] > 0 and flat["moved_bytes"] > 0
        assert r["chain"]["profiles"][1]["moved_bytes"] > 0
    for rank in (0, 1):
        assert port[rank]["chain"]["losses"][4:] == [None, None]
        assert port[rank]["chain"]["weights"] is None
    assert any(port[rank]["chain"]["switch_records"] for rank in (0, 1))
    assert all(rec[5] == "switch" and rec[4] == "world"
               for r in port for rec in r["chain"]["switch_records"])


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def _tiny_graph(**cfg):
    mesh = create_mesh({"dp": 1}, device="cpu")
    with ht.graph("define_and_run", create_new=True, mesh=mesh,
                  seed=0) as g:
        ids = ht.parallel_placeholder("int32", (B, S), pspec=P("dp", None))
        labels = ht.parallel_placeholder("int32", (B, S),
                                         pspec=P("dp", None))
        model = GPTLMHeadModel(GPTConfig(**{**CFG, **cfg}))
        loss = model(ids, labels)
        opt = optim.AdamOptimizer(lr=1e-3)
        op = opt.minimize(loss)
    x, y = _batch()
    return g, model, opt, loss, op, {ids: x, labels: y}


def test_identity_switch_trains_bitwise_as_before():
    """A size-1 mesh switched onto an identity mesh: a new strategy id,
    the plans keyed by it, the same losses bit for bit."""
    runs = []
    for switch in (False, True):
        g, model, opt, loss, op, feed = _tiny_graph()
        out = []
        for step in range(6):
            if switch and step == 3:
                prof = g.switch_strategy(create_mesh({"dp": 1}, device="cpu"),
                                         optimizer=opt)
                assert g.cur_strategy_id == 1 and g.num_strategy == 2
                assert prof.moved_bytes == 0
            out.append(float(g.run(loss, [loss, op], feed)[0]))
        runs.append(out)
        if switch:
            assert len(g._plan_pool) == 2
            assert {k[-1] for k in g._plan_pool} == {0, 1}
            g.run(loss, [loss, op], feed, cur_strategy_id=1)
            with pytest.raises(ValueError, match="switch_strategy"):
                g.run(loss, [loss, op], feed, cur_strategy_id=0)
    assert runs[0] == runs[1]


def test_switch_probes():
    g, model, opt, loss, op, feed = _tiny_graph()
    g.run(loss, [loss, op], feed)
    with pytest.raises(ValueError, match="mesh"):
        g.switch_strategy()
    with pytest.raises(ValueError, match="optimizer"):
        g.switch_strategy(create_mesh({"dp": 1}, device="cpu"),
                          optimizer=None,
                          mode=SwitchMode.ORIGIN_PARAM_AND_OPTIMIZER)
    with pytest.raises(ValueError, match="mesh"):
        with ht.graph("define_and_run", create_new=True,
                      device="cpu") as g2:
            pass
        g2.switch_strategy(create_mesh({"dp": 1}, device="cpu"))
    with ht.graph("define_and_run", create_new=True, device="cpu",
                  num_strategy=3) as g3:
        assert g3.num_strategy == 3


def test_missing_axis_dropped_and_persisted():
    """A mesh without ``tp``: the specs lose it, and it stays lost."""
    g, model, opt, loss, op, feed = _tiny_graph()
    g.run(loss, [loss, op], feed)
    qkv = dict(model.named_parameters())["transformer.h.0.attn.qkv.weight"]
    assert "tp" in str(qkv.pspec)
    g.switch_strategy(create_mesh({"dp": 1}, device="cpu"), optimizer=opt)
    assert "tp" not in str(qkv.pspec)
    g.run(loss, [loss, op], feed)
    assert "tp" not in str(qkv.pspec)


def test_transfer_param_casts_the_variables():
    g, model, opt, loss, op, feed = _tiny_graph()
    g.run(loss, [loss, op], feed)
    g.switch_strategy(create_mesh({"dp": 1}, device="cpu"),
                      mode=SwitchMode.TRANSFER_PARAM, dtype="bfloat16")
    import torch
    assert all(v.dtype == torch.bfloat16 for v in g._var_data.values())
