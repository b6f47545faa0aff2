"""The port's SPMD pipeline (``parallel.pipeline``, ``models.gpt_pipeline``)
against the JAX package's, on the CPU at a tiny size.

The JAX ``GPTPipelineModel`` trains at pp 1 (3 Adam steps at lr 1e-2, 2
micro-batches; tiny LLaMA, its GQA twin with 2 kv heads, and a GPT-2
style config) in this process, and its weights start every port run:
the port's pp 1 in this process (every loss within 2e-5), and in one
group of 4 gloo ranks (``tests/torch_ranks.py``) pp 2 x dp 2, pp 2 x tp
2 (with ``sp``, and with GQA), pp 4, pp 2 on a spare ``r`` axis at 2
and 4 micro-batches, and pp 2 x dp 2 under ZeRO-1: within the JAX
tests' own ``rtol=3e-3, atol=1e-4`` of JAX's pp 1 at every step and
within 2e-5 at step 1.  The same group checks ``comm.permute_group``'s
gradient (the inverse permutation, ``gradcheck`` in float64),
``pipeline_spmd``'s aux (MoE's balance loss: a micro-batch mean of the
stages' sums, bubbles masked), that the
gathered weights equal the loaded ones, that the ``wte`` gradient of a
pp 2 run equals one process's (the pp sum of the input's gradient), the
hops and collects of a step, and which parameters ZeRO splits.
"""
import numpy as np
import pytest

from torch_ranks import run_ranks

KW = dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=4,
          max_seq_len=16, sp=False)
CONFIGS = {"llama": ("llama_config", {}),
           "llama_gqa": ("llama_config", {"num_kv_heads": 2}),
           "gpt2": ("GPTConfig", {})}
STEPS, LR, MICRO = 3, 1e-2, 2
# (name, mesh, config overrides, micro-batches, optimizer options)
LAYOUTS = {
    "llama": [
        ("pp2_dp2", {"pp": 2, "dp": 2, "tp": 1}, {}, MICRO, {}),
        ("pp2_tp2", {"pp": 2, "dp": 1, "tp": 2}, {}, MICRO, {}),
        ("pp2_tp2_sp", {"pp": 2, "dp": 1, "tp": 2}, {"sp": True}, MICRO,
         {}),
        ("pp4", {"pp": 4, "dp": 1, "tp": 1}, {}, MICRO, {}),
        ("pp2_m2", {"r": 2, "pp": 2}, {}, 2, {}),
        ("pp2_m4", {"r": 2, "pp": 2}, {}, 4, {}),
        ("pp2_dp2_zero1", {"pp": 2, "dp": 2, "tp": 1}, {}, MICRO,
         {"zero": 1})],
    "llama_gqa": [
        ("pp2_tp2_gqa", {"pp": 2, "dp": 1, "tp": 2}, {}, MICRO, {})],
    "gpt2": [
        ("pp2_dp2", {"pp": 2, "dp": 2, "tp": 1}, {}, MICRO, {}),
        ("pp2_tp2", {"pp": 2, "dp": 1, "tp": 2}, {}, MICRO, {})]}
RING = [(0, 1), (1, 2), (2, 3), (3, 0)]
AUX_X = np.arange(12, dtype=np.float64).reshape(4, 3) / 7.0
AUX_WS = [0.5, -1.5]
SHUFFLE = [(0, 2), (2, 1), (1, 3), (3, 0)]


def _batch():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 64, (8, 16)).astype(np.int32)
    return x, np.roll(x, -1, 1)


def _jax_pp1(name):
    """JAX's GPTPipelineModel at pp 1 (the JAX tests' ``_train``): its
    initial state and losses."""
    from jax.sharding import PartitionSpec as JP
    import hetu_tpu as jht
    from hetu_tpu import optim as joptim
    from hetu_tpu.graph import ctor as jctor
    from hetu_tpu.models import gpt as jgpt
    from hetu_tpu.models.gpt_pipeline import GPTPipelineModel as JPipe
    fn, kw = CONFIGS[name]
    jctor._seed_counter[0] = 555
    cfg = getattr(jgpt, fn)(**KW, **kw)
    x, y = _batch()
    with jht.graph("define_and_run", create_new=True,
                   mesh=jht.create_mesh({"pp": 1, "dp": 1, "tp": 1})) as g:
        ids = jht.parallel_placeholder("int32", x.shape, pspec=JP("dp", None))
        lbl = jht.parallel_placeholder("int32", y.shape, pspec=JP("dp", None))
        m = JPipe(cfg, num_stages=1)
        loss = m(ids, lbl, num_micro_batches=MICRO)
        op = joptim.AdamOptimizer(lr=LR).minimize(loss)
        state = {k: np.asarray(v) for k, v in m.state_dict().items()}
        losses = [float(np.asarray(g.run(loss, [loss, op],
                                          {ids: x, lbl: y})[0]))
                  for _ in range(STEPS)]
    return state, losses


def _port_pp1(name, state):
    """The port's GPTPipelineModel at pp 1 in this process: losses and
    the first batch's ``wte`` gradient at the initial weights."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.models import gpt as tgpt
    from hetu_tpu_torch.models.convert import load_module_state
    from hetu_tpu_torch.models.gpt_pipeline import GPTPipelineModel
    fn, kw = CONFIGS[name]
    cfg = getattr(tgpt, fn)(**KW, **kw)
    x, y = _batch()
    with ht.graph("define_and_run", create_new=True, device="cpu",
                  seed=0) as g:
        ids = ht.placeholder("int32", x.shape)
        lbl = ht.placeholder("int32", y.shape)
        m = GPTPipelineModel(cfg, num_stages=1)
        loss = m(ids, lbl, num_micro_batches=MICRO)
        (gw,) = ht.gradients(loss, [m.wte.weight])
        op = optim.AdamOptimizer(lr=LR).minimize(loss)
    load_module_state(m, state)
    (wte_grad,) = g.run([gw], feed_dict={ids: x, lbl: y})
    losses = [float(g.run(loss, [loss, op], {ids: x, lbl: y})[0])
              for _ in range(STEPS)]
    return losses, wte_grad.numpy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's pp 1 runs, the port's pp 1 runs, and the one rank group:
    (jax, port, rank results)."""
    tmp = tmp_path_factory.mktemp("pipeline")
    x, y = _batch()
    np.savez(tmp / "batch.npz", x=x, y=y)
    jax, port = {}, {}
    jobs = [("permute", {"perms": [RING, SHUFFLE]}),
            ("aux", {"x": AUX_X, "ws": AUX_WS, "micro": 2})]
    for name in CONFIGS:
        state, losses = _jax_pp1(name)
        jax[name] = losses
        port[name] = _port_pp1(name, state)
        np.savez(tmp / f"{name}.npz", **state)
        fn, kw = CONFIGS[name]
        jobs.append(("pipeline", {
            "state_path": str(tmp / f"{name}.npz"),
            "batch_path": str(tmp / "batch.npz"),
            "mk": {"fn": fn, "kw": {**KW, **kw}}, "layouts": LAYOUTS[name],
            "steps": STEPS, "lr": LR}))
    res = run_ranks("many", 4, {"jobs": jobs}, tmp, timeout=240.0)
    return jax, port, res


@pytest.mark.parametrize("name", list(CONFIGS))
def test_pp1_matches_jax(runs, name):
    jax, port, _ = runs
    np.testing.assert_allclose(port[name][0], jax[name], rtol=0, atol=2e-5)
    assert jax[name][-1] < jax[name][0]


def _layouts():
    return [(name, lay[0], i + 2) for i, name in enumerate(CONFIGS)
            for lay in LAYOUTS[name]]


@pytest.mark.parametrize("name,layout,job", _layouts())
def test_layout_matches_jax_pp1(runs, name, layout, job):
    """Every rank's losses equal; rank 0's within the JAX tests' own
    tolerance of JAX's pp 1 at every step and within 2e-5 at step 1; the
    gathered weights are the loaded ones."""
    jax, _, res = runs
    got = [r[job][layout] for r in res]
    assert all(g["losses"] == got[0]["losses"] for g in got)
    losses = got[0]["losses"]
    np.testing.assert_allclose(losses, jax[name], rtol=3e-3, atol=1e-4)
    assert abs(losses[0] - jax[name][0]) <= 2e-5
    assert max(g["init_diff"] for g in got) == 0.0


def test_micro_batch_counts_agree(runs):
    _, _, res = runs
    a = res[0][2]["pp2_m2"]["losses"]
    b = res[0][2]["pp2_m4"]["losses"]
    np.testing.assert_allclose(a, b, rtol=3e-3, atol=1e-4)


def test_wte_gradient_is_one_processes(runs):
    """The input's gradient is summed over pp (only stage 0 reads it), so
    each pp rank's ``wte`` gradient is one process's, not 0 or S times
    it."""
    _, port, res = runs
    want = port["llama"][1]
    for r in res:
        np.testing.assert_allclose(r[2]["pp2_m2"]["wte_grad"], want,
                                   rtol=1e-4, atol=1e-7)
    assert np.abs(want).max() > 0


@pytest.mark.parametrize("micro,layout", [(2, "pp2_m2"), (4, "pp2_m4")])
def test_hops_and_collects_of_a_step(runs, micro, layout):
    """A step issues ``M + S - 2`` hops each way (``pipeline/hop``: every
    tick's but the last, which no stage reads), the forward's collect
    (``spmd_hop_schedule`` without an aux) and the all-reduce of the
    input's gradient over pp."""
    from hetu_tpu_torch.parallel.pipeline import spmd_hop_schedule
    _, _, res = runs
    H = micro + 2 - 2
    for r in res:
        recs = [x for x in r[2][layout]["records"] if x[4] == "pp"]
        hops = [x for x in recs if x[0] == "ppermute"]
        assert len(hops) == 2 * H
        assert all(x[5] == "pipeline/hop" for x in hops)
        fwd = [(x[0], x[5]) for x in recs if x[5].startswith("pipeline")]
        assert fwd[:H + 1] == spmd_hop_schedule(micro, 2, with_aux=False)
        assert [x[0] for x in recs if not x[5]] == ["all_reduce"]


def test_zero_leaves_the_stacked_blocks_whole(runs):
    """ZeRO splits a parameter over dp along dim 0 only where no other
    axis splits that dim: the embedding and head, never the pp-stacked
    blocks (the JAX package's rule)."""
    _, _, res = runs
    chunked = res[0][2]["pp2_dp2_zero1"]["zero_chunked"]
    assert "wte.weight" in chunked and "lm_head" in chunked
    assert not [n for n in chunked if n.startswith("blk_")]


def test_aux_is_the_micro_batch_mean_of_stage_sums(runs):
    """``with_aux``: the aux is the micro-batch mean of every stage's sum
    with the bubble ticks masked out, as one process computes it, and its
    gradient reaches the input and each stage's weight."""
    import torch
    _, _, res = runs
    x = torch.from_numpy(AUX_X).requires_grad_(True)
    w = torch.tensor(AUX_WS, dtype=torch.float64, requires_grad=True)
    aux = sum(((m * w[0]).sum() + (m * w[0] * w[1]).sum())
              for m in x.chunk(2, 0)) / 2
    out = x * w[0] * w[1]
    gx, gw = torch.autograd.grad(out.sum() + aux, [x, w])
    for r in res:
        got = r[1]
        np.testing.assert_allclose(got["out"], out.detach().numpy())
        np.testing.assert_allclose(got["aux"], float(aux.detach()))
        np.testing.assert_allclose(got["gx"], gx.numpy())
        np.testing.assert_allclose(got["gw"], float(gw[got["stage"]]))


@pytest.mark.parametrize("i,perm", [(0, RING), (1, SHUFFLE)])
def test_permute_group_gradient_is_the_inverse(runs, i, perm):
    _, _, res = runs
    dst = dict(perm)
    src = {d: s for s, d in perm}
    for rank, r in enumerate(res):
        got = r[0][i]
        assert got["gradcheck"]
        want_y = np.arange(6, dtype=np.float64).reshape(3, 2) + 10 * src[rank]
        np.testing.assert_array_equal(got["y"], want_y)
        np.testing.assert_array_equal(got["grad"], np.full(
            (3, 2), float(dst[rank] + 1)))
        kinds = [(x[0], x[5]) for x in got["records"]]
        assert kinds == [("ppermute", "hop")] * 2


@pytest.mark.parametrize("kw,exc,match", [
    ({"dropout": 0.1}, NotImplementedError, "dropout"),
    ({"num_experts": 4, "moe_every": 2}, NotImplementedError,
     "every layer MoE"),
    ({"num_layers": 6}, ValueError, "not divisible")])
def test_refusals(kw, exc, match):
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.models import llama_config
    from hetu_tpu_torch.models.gpt_pipeline import GPTPipelineModel
    cfg = llama_config(**{**KW, **kw})
    with ht.graph("define_and_run", create_new=True, device="cpu"):
        with pytest.raises(exc, match=match):
            GPTPipelineModel(cfg, num_stages=4 if "num_layers" in kw else 1)
