"""Expert parallelism and the MoE pipeline on 4 gloo ranks of the CPU,
against one process and the JAX package (``tests/torch_ranks.py``; the
helpers and the single-process cases are tests/test_torch_moe.py's):
``{"dp": 2, "ep": 2}``, ``{"ep": 4}``, dp 2 x tp 2 with sp and dp 2 x
ep 2 under ZeRO-2 (losses within 1e-4, updates within 1 %), the
collectives they record, the grad-comm region's local routing, and
``GPTPipelineModel`` at pp 2 x dp 2 and pp 2 x ep 2.  The grad-comm
layout is held against the JAX package's run on 4 CPU devices, where its
explicit grad-comm region runs.
"""
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as JP

import hetu_tpu as jht
from hetu_tpu import optim as joptim
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPTLMHeadModel
import hetu_tpu_torch as ht
from hetu_tpu_torch import optim
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel, llama_config
from hetu_tpu_torch.models.convert import load_state, state_numpy

from test_torch_moe import (PIPE_KW, _jax_pipeline, _jax_state, _np,
                            _pipe_batch, _update_gap)
from torch_ranks import GRAD_COMM_ROUTES, grad_comm_graph, run_ranks


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------

EP_KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             max_seq_len=16, num_experts=4, moe_top_k=2,
             moe_capacity_factor=1.25, dtype="float32", ep_axis="ep")
EP_LAYOUTS = [("dp2_ep2", {"dp": 2, "ep": 2}, False, {}),
              ("ep4", {"ep": 4}, False, {}),
              ("dp2_tp2_sp", {"dp": 2, "tp": 2}, True, {}),
              ("dp2_ep2_zero2", {"dp": 2, "ep": 2}, False, {"zero": 2}),
              ("dp4_grad_comm", {"dp": 4}, False, {"grad_comm": "fp32"})]
EP_STEPS, EP_LR, EP_MICRO = 3, 1e-2, 2


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("moe_ep")
    kw = {k: v for k, v in EP_KW.items() if k != "ep_axis"}
    state = _jax_state({**kw, "sp": False})
    np.savez(tmp / "state.npz", **state)
    rng = np.random.RandomState(0)
    x = rng.randint(0, 64, (8, 16)).astype(np.int32)
    y = np.roll(x, -1, 1)
    np.savez(tmp / "batch.npz", x=x, y=y)
    jl, jw = _jax_train(kw, state, x, y)
    one_l, one_w = _port_train(kw, state, x, y)
    jobs = {"moe": dict(state_path=str(tmp / "state.npz"),
                        batch_path=str(tmp / "batch.npz"), cfg_kw=EP_KW,
                        layouts=EP_LAYOUTS, lr=EP_LR, steps=EP_STEPS,
                        micro=EP_MICRO)}
    routes = dict(state_path=str(tmp / "state.npz"),
                  batch_path=str(tmp / "batch.npz"), cfg_kw=kw,
                  micro=EP_MICRO)
    res = run_ranks("many", 4, {"jobs": [("train_many", {"jobs": jobs}),
                                         ("grad_comm_routing", routes)]},
                    tmp, timeout=240.0)
    return {"jax": (jl, jw), "one": (one_l, one_w),
            "jax_grad_comm": _jax_grad_comm_train(devices8, kw, state, x, y),
            "jax_routes": _jax_grad_comm_routes(devices8, kw, x),
            "ranks": [r[0]["moe"] for r in res],
            "routes": [r[1] for r in res], "state": state, "x": x, "y": y}


def _jax_pkg():
    from hetu_tpu import ops as jops
    return jht, joptim, JaxGPTConfig, JaxGPTLMHeadModel, jops.functional


def _jax_grad_comm_train(devices, kw, state, x, y):
    """The JAX package's run of ``EP_LAYOUTS``' ``dp4_grad_comm`` on 4 CPU
    devices: (losses, weights, whether its explicit grad-comm region ran,
    why not)."""
    from hetu_tpu_torch.models.generate import _Params
    mesh = JaxMesh(np.array(devices[:4]), ("dp",))
    g, model, _, loss, fetches, op, feeds = grad_comm_graph(
        _jax_pkg(), JP, kw, x.shape, "loss", mesh=mesh)
    model.load_state_dict(state)
    losses = [float(_np(g.run(loss, fetches + [op], feeds(x, y),
                              num_micro_batches=EP_MICRO)[0]))
              for _ in range(EP_STEPS)]
    return losses, {_Params._norm(k): _np(v)
                    for k, v in model.state_dict().items()}, \
        g._grad_comm_active, g._grad_comm_fallback


def _jax_grad_comm_routes(devices, kw, x):
    """For each ``GRAD_COMM_ROUTES`` entry, whether the JAX graph plans
    its explicit grad-comm region, as its step builder asks it (no step
    is compiled)."""
    mesh = JaxMesh(np.array(devices[:4]), ("dp",))
    out = {}
    for name in GRAD_COMM_ROUTES:
        g, _, opt, loss, fetches, _, feeds = grad_comm_graph(
            _jax_pkg(), JP, kw, x.shape, name, mesh=mesh)
        plan = None
        if opt.grad_comm is not None:     # the step builder's own test
            plan, _ = g._plan_explicit_grad_comm(
                opt, fetches, list(feeds(x, x)), EP_MICRO, loss_t=loss)
        out[name] = plan is not None
    return out


def _jax_train(kw, state, x, y):
    with jht.graph("define_and_run", create_new=True) as g:
        ids = jht.placeholder("int32", x.shape, name="ids")
        labels = jht.placeholder("int32", y.shape, name="labels")
        model = JaxGPTLMHeadModel(JaxGPTConfig(**kw, sp=False))
        loss = model(ids, labels)
        op = joptim.AdamOptimizer(lr=EP_LR).minimize(loss)
        model.load_state_dict(state)
        losses = [float(_np(g.run(loss, [loss, op], {ids: x, labels: y},
                                  num_micro_batches=EP_MICRO)[0]))
                  for _ in range(EP_STEPS)]
    from hetu_tpu_torch.models.generate import _Params
    return losses, {_Params._norm(k): _np(v)
                    for k, v in model.state_dict().items()}


def _port_train(kw, state, x, y):
    with ht.graph("define_and_run", create_new=True, device="cpu",
                  seed=0) as g:
        ids = ht.placeholder("int32", x.shape, name="ids")
        labels = ht.placeholder("int32", y.shape, name="labels")
        model = GPTLMHeadModel(GPTConfig(**kw, sp=False))
        loss = model(ids, labels)
        op = optim.AdamOptimizer(lr=EP_LR).minimize(loss)
    load_state(model, state)
    losses = [float(g.run(loss, [loss, op], {ids: x, labels: y},
                          num_micro_batches=EP_MICRO)[0])
              for _ in range(EP_STEPS)]
    return losses, state_numpy(model)


@pytest.mark.parametrize("layout", [lay[0] for lay in EP_LAYOUTS
                                    if lay[0] != "dp4_grad_comm"])
def test_expert_parallel_matches_one_process_and_jax(ep_runs, layout):
    """Every rank the same loss; losses within 1e-4 of one process's and
    of JAX's single-device run, the gathered weights' updates within 1 %
    of both (phase 8's limits)."""
    from hetu_tpu_torch.models.generate import _Params
    init = {_Params._norm(k): v for k, v in ep_runs["state"].items()}
    r0 = ep_runs["ranks"][0][layout]
    for r in ep_runs["ranks"]:
        assert r[layout]["losses"] == r0["losses"]
    for ref_l, ref_w in (ep_runs["one"], ep_runs["jax"]):
        assert max(abs(a - b) for a, b in zip(r0["losses"], ref_l)) <= 1e-4
        assert set(r0["weights"]) == set(ref_w)
        assert _update_gap(r0["weights"], ref_w, init) <= 0.01
    assert r0["losses"][-1] < r0["losses"][0]


def test_expert_parallel_collectives(ep_runs):
    """Under ep each MoE layer gathers its experts' outputs over ep in the
    forward and the dispatched gradient in the backward (all-gathers on
    axis ep), and under dp the gate gathers its counts over dp; no
    all-to-all (tokens repeat over ep)."""
    recs = ep_runs["ranks"][0]["ep4"]["records"]
    ep_gathers = [r for r in recs if r[0] == "all_gather" and r[4] == "ep"]
    # 2 layers x (forward + backward) x 2 micro-batches x 3 steps
    assert len(ep_gathers) == 2 * 2 * EP_MICRO * EP_STEPS
    assert not [r for r in recs if r[0] == "all_to_all"]
    dp = ep_runs["ranks"][0]["dp2_ep2"]["records"]
    counts = [r for r in dp if r[0] == "all_gather" and r[4] == "dp"]
    assert len(counts) == 2 * EP_MICRO * EP_STEPS


def test_grad_comm_region_routes_each_ranks_tokens(ep_runs):
    """A dp-only mesh with ``grad_comm`` runs the model on each rank's own
    tokens, as the JAX package's explicit grad-comm region does: the gate
    of each rank routes its 2 rows alone (capacity from 32 tokens, no
    dp gathers of counts), so the losses are a one-process run's on
    each quarter of the batch, averaged."""
    r = ep_runs["ranks"][0]["dp4_grad_comm"]
    assert not [x for x in r["records"]
                if x[0] == "all_gather" and x[4] == "dp"]
    kw = {k: v for k, v in EP_KW.items() if k != "ep_axis"}
    state, x, y = ep_runs["state"], ep_runs["x"], ep_runs["y"]
    # step 1's loss: the mean over the 4 ranks of their local losses
    with ht.graph("define_and_run", create_new=True, device="cpu") as g:
        ids = ht.placeholder("int32", (1, 16), name="ids")
        labels = ht.placeholder("int32", (1, 16), name="labels")
        model = GPTLMHeadModel(GPTConfig(**kw, sp=False))
        loss = model(ids, labels)
    load_state(model, state)
    parts = []
    for q in range(4):
        # rank q's micro-batches: row q of each half of the global batch
        rows = [q, 4 + q]
        parts.append(np.mean([float(g.run(loss, feed_dict={
            ids: x[i:i + 1], labels: y[i:i + 1]})[0]) for i in rows]))
    assert abs(r["losses"][0] - float(np.mean(parts))) <= 1e-5


def test_grad_comm_region_matches_jax(ep_runs):
    """``dp4_grad_comm`` against the JAX package's run on a 4-device CPU
    mesh, where its explicit grad-comm region runs: every rank the same
    losses, within 1e-4 of JAX's over 3 steps, and each weight's update
    within 1 % of JAX's."""
    from hetu_tpu_torch.models.generate import _Params
    jl, jw, active, why = ep_runs["jax_grad_comm"]
    assert active, why
    init = {_Params._norm(k): v for k, v in ep_runs["state"].items()}
    got = [r["dp4_grad_comm"] for r in ep_runs["ranks"]]
    assert all(r["losses"] == got[0]["losses"] for r in got)
    assert max(abs(a - b) for a, b in zip(got[0]["losses"], jl)) <= 1e-4
    assert set(got[0]["weights"]) == set(jw)
    assert _update_gap(got[0]["weights"], jw, init) <= 0.01
    # the local routing changes the losses: the global view's differ
    assert max(abs(a - b) for a, b in
               zip(got[0]["losses"], ep_runs["jax"][0])) > 1e-3


@pytest.mark.parametrize("route", list(GRAD_COMM_ROUTES))
def test_grad_comm_routing_follows_the_jax_region(ep_runs, route):
    """The port routes each rank's tokens alone exactly where the JAX
    graph plans its explicit grad-comm region (``grad_comm``, ZeRO below
    3, only the loss as a scalar fetch, every other fetch split over dp,
    a loss not summed); where JAX falls back to the global view, so does
    the port: its first loss is then one process's."""
    want = ep_runs["jax_routes"][route]
    assert want == (route in ("loss", "loss_and_ids"))
    for r in ep_runs["routes"]:
        assert r[route]["local"] == want
    first = ep_runs["routes"][0][route]["first_loss"]
    if route == "extra_scalar":
        assert abs(first - ep_runs["one"][0][0]) <= 1e-5
    elif route == "loss":
        assert abs(first - ep_runs["jax_grad_comm"][0][0]) <= 1e-4


# ---------------------------------------------------------------------------
# the MoE pipeline on 4 gloo ranks
# ---------------------------------------------------------------------------

PIPE_LAYOUTS = [("pp2_dp2", {"pp": 2, "dp": 2}, {}, 2, {}),
                ("pp2_ep2", {"pp": 2, "ep": 2}, {"ep_axis": "ep"}, 2, {})]


@pytest.fixture(scope="module")
def pipe_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_pipe")
    init, jl, jw = _jax_pipeline()
    np.savez(tmp / "state.npz", **init)
    np.savez(tmp / "batch.npz", **dict(zip(("x", "y"), _pipe_batch())))
    mk = {"fn": "llama_config", "kw": PIPE_KW}
    res = run_ranks("many", 4, {"jobs": [
        ("pipeline", {"state_path": str(tmp / "state.npz"),
                      "batch_path": str(tmp / "batch.npz"), "mk": mk,
                      "layouts": PIPE_LAYOUTS, "steps": 3, "lr": 1e-2}),
        ("pipeline_feed_refusal", {"mk": mk, "shape": (4, 8),
                                   "mesh_shape": {"pp": 2, "dp": 2}})]},
        tmp, timeout=240.0)
    return init, jl, jw, [r[0] for r in res], [r[1] for r in res]


@pytest.mark.parametrize("layout", [lay[0] for lay in PIPE_LAYOUTS])
def test_moe_pipeline_on_a_mesh_matches_jax(pipe_runs, layout):
    """The MoE pipeline at pp 2 with dp 2 (each rank's pipeline
    micro-batch its shard of the global one, ``feed_groups``) and with
    ep 2 (the experts split inside the stages): every rank the same
    losses, within 1e-4 of JAX's pp 1 run (the JAX tests hold pp 2 x dp
    2 within 3e-3), and each gathered weight's update within 1 %."""
    from hetu_tpu_torch.models.convert import plain_state
    init, jl, jw, res, _ = pipe_runs
    cfg = llama_config(**PIPE_KW)
    got = [r[layout] for r in res]
    assert all(g["losses"] == got[0]["losses"] for g in got)
    np.testing.assert_allclose(got[0]["losses"], jl, rtol=0, atol=1e-4)
    assert max(g["init_diff"] for g in got) == 0.0
    pw, want, start = (plain_state(s, cfg) for s in
                       (got[0]["state"], jw, init))
    for k, v in want.items():
        assert _update_gap({k: pw[k]}, {k: v}, {k: start[k]}) <= 0.01, k


def test_moe_pipeline_under_dp_refuses_ids_from_another_op(pipe_runs):
    """Under dp the MoE pipeline's gate routes the global micro-batch,
    which the feed split of a placeholder gives: ids from another op
    raise on every rank."""
    for msg in pipe_runs[4]:
        assert msg is not None and "placeholders" in msg and \
            "'reshape'" in msg
