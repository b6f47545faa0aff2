"""The port's collectives (``hetu_tpu_torch.parallel.comm``) against the
JAX package's, on the CPU.

Four gloo ranks (tests/torch_ranks.py, one launch) run every plain and
coalesced collective over an axis of 4 ranks (mesh ``{"x": 4}``) and of
2 (``{"r": 2, "x": 2}``: two groups of 2), on per-rank inputs made from
a seed with numpy; the JAX functions run in ``shard_map`` over 4 and 2
virtual devices on the same inputs.  fp32 results within 1e-6; the bf16
and int8 transports within the JAX package's tiers of the exact sum
(tests/test_comm_coalesced.py: 1e-2 and 2.5e-2 of the largest value),
and within one quantization step of JAX's own result; int8 codes and
scales equal JAX's.  The autograd pairs' gradients are the conjugate
collectives.  ``CommStats`` records of one optimizer update equal the
port's ``predict_grad_comm_collectives`` / ``predict_flat_update_
collectives`` in kind, count, payload bytes and dtype.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import PartitionSpec as JP

from hetu_tpu.parallel import comm as jcomm
from hetu_tpu.parallel import create_mesh as jax_create_mesh
from hetu_tpu_torch.parallel import comm, dstates
from torch_ranks import run_ranks

WORLD = 4
ROWS = 12               # divisible by every subgroup size used
MESHES = {4: {"x": 4}, 2: {"r": 2, "x": 2}}
ENTRIES = [("w0", (64, 32), "float32"), ("b0", (32,), "float32"),
           ("w1", (7, 5), "float32"), ("b1", (300,), "float32"),
           ("w2", (96, 8), "bfloat16")]
BUCKET_MB = 0.008
STATS_LAYOUTS = [(f"{tr}_{kind}", kw) for tr in ("fp32", "bf16", "int8")
                 for kind, kw in (
                     ("zero0", {"grad_comm": tr}),
                     ("flat_zero2", {"grad_comm": tr, "zero": 2,
                                     "flat_state": True}),
                     ("flat_zero3", {"grad_comm": tr, "zero": 3,
                                     "flat_state": True}))]


CE_MESHES = [{"dp": 4}, {"dp": 2, "tp": 2}, {"tp": 4}]


def _ce_inputs(seed=3):
    """Global logits [8, 6, 64] and labels with ignored (-100) tokens."""
    rng = np.random.RandomState(seed)
    logits = (3.0 * rng.standard_normal((8, 6, 64))).astype(np.float32)
    labels = rng.randint(0, 64, (8, 6)).astype(np.int64)
    labels[rng.rand(8, 6) < 0.25] = -100
    return logits, labels


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((ROWS, 3)).astype(np.float32)
            for _ in range(WORLD)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("comm")
    xs = _inputs()
    jobs = [("collectives", dict(mesh_shape=MESHES[n], inputs=xs))
            for n in (4, 2)]
    jobs += [("stats", dict(mesh_shape={"dp": 4} if n == 4 else
                            {"r": 2, "dp": 2}, entries=ENTRIES,
                            layouts=STATS_LAYOUTS, bucket_mb=BUCKET_MB))
             for n in (4, 2)]
    logits, labels = _ce_inputs()
    jobs += [("ce", dict(mesh_shape=shape, logits=logits, labels=labels))
             for shape in CE_MESHES]
    res = run_ranks("many", WORLD, {"jobs": jobs}, tmp)
    return {"coll": {4: [r[0] for r in res], 2: [r[1] for r in res]},
            "stats": {4: res[0][2], 2: res[0][3]},
            "ce": [[r[4 + k] for r in res] for k in range(len(CE_MESHES))]}


def _jax_each(fn, xs, devices):
    """``fn`` of each device's input under ``shard_map`` over axis "x"."""
    n = len(xs)
    mesh = jax_create_mesh({"x": n}, devices[:n])
    f = jcomm.shard_map(lambda v: jax.tree_util.tree_map(
        lambda o: o[None], fn(v)), mesh, (JP("x"),), JP("x"))
    out = jax.jit(f)(jnp.asarray(np.concatenate(xs, 0)))
    return [jax.tree_util.tree_map(lambda o: np.asarray(o[i], np.float32),
                                   out) for i in range(n)]


JAX_FNS = {
    "all_reduce": lambda v: jcomm.all_reduce(v, "x"),
    "all_reduce_max": lambda v: jcomm.all_reduce(v, "x", "max"),
    "all_reduce_mean": lambda v: jcomm.all_reduce(v, "x", "mean"),
    "all_gather0": lambda v: jcomm.all_gather(v, "x", 0),
    "all_gather1": lambda v: jcomm.all_gather(v, "x", 1),
    "reduce_scatter": lambda v: jcomm.reduce_scatter(v, "x", 0),
    "all_to_all": lambda v: jcomm.all_to_all(v, "x", 0, 1),
    "broadcast": lambda v: jcomm.broadcast(v, "x", 1),
    "reduce": lambda v: jcomm.reduce(v, "x", 0),
    "ring_shift": lambda v: jcomm.ring_shift(v, "x", 1),
    "partial_reduce": lambda v: jcomm.partial_reduce(
        v, "x", lax.axis_index("x") % 2 == 0),
}


def _groups(xs, n):
    """The per-group inputs of the axis of size ``n`` over 4 ranks."""
    return [xs[i:i + n] for i in range(0, WORLD, n)]


@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("name", sorted(JAX_FNS))
def test_plain_collective_equals_jax(ranks, devices8, n, name):
    xs = _inputs()
    got = [r[name] for r in ranks["coll"][n]]
    want = [w for grp in _groups(xs, n)
            for w in _jax_each(JAX_FNS[name], grp, devices8)]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [4, 2])
def test_split_collectives_equal_jax(ranks, devices8, n):
    """Subgroup collectives over unequal groups ([[0], [1..n-1]]), with
    the JAX package's padded shapes."""
    xs = _inputs()
    uneven = [[0], list(range(1, n))]
    fns = {"split_all_gather":
           lambda v: jcomm.split_all_gather(v, "x", 0, uneven)}
    for name, fn in fns.items():
        want = [w for grp in _groups(xs, n)
                for w in _jax_each(fn, grp, devices8)]
        for r, w in zip(ranks["coll"][n], want):
            np.testing.assert_allclose(r[name], w, rtol=1e-6, atol=1e-6)
    # psum over unequal axis_index_groups and the scatter: numpy's sums
    for gi, grp in enumerate(_groups(xs, n)):
        for i, r in enumerate(ranks["coll"][n][gi * n:(gi + 1) * n]):
            own = uneven[0] if i == 0 else uneven[1]
            total = sum(grp[j] for j in own)
            np.testing.assert_allclose(r["split_all_reduce"], total,
                                       rtol=1e-6, atol=1e-6)
            chunk = ROWS // len(own)
            k = own.index(i)
            want = np.zeros((ROWS, 3), np.float32)
            want[:chunk] = total[k * chunk:(k + 1) * chunk]
            np.testing.assert_allclose(r["split_reduce_scatter"], want,
                                       rtol=1e-6, atol=1e-6)


def _coalesced_jax(transport, op_fn):
    def fn(v):
        g = {"a": v[:3], "b": v[3:].reshape(-1)}
        return op_fn(g, transport)
    return fn


def _ar(g, tr):
    return jcomm.all_reduce_coalesced(g, "x", op="mean", transport=tr,
                                      block=4)


def _rs_ag(g, tr):
    chunks, lay = jcomm.reduce_scatter_coalesced(g, "x", op="sum",
                                                 transport=tr, block=4)
    return jcomm.all_gather_coalesced(chunks, lay, "x", transport=tr,
                                      block=4)


TIERS = {"fp32": 1e-6, "bf16": 1e-2, "int8": 2.5e-2}


@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("transport", ["fp32", "bf16", "int8"])
def test_coalesced_collectives_equal_jax(ranks, devices8, n, transport):
    xs = _inputs()
    for key, fn, mean in (("coalesced", _ar, True), ("rs_ag", _rs_ag, False)):
        want = [w for grp in _groups(xs, n) for w in _jax_each(
            _coalesced_jax(transport, fn), grp, devices8)]
        for gi, grp in enumerate(_groups(xs, n)):
            exact = sum(grp) / (n if mean else 1)
            exact = {"a": exact[:3], "b": exact[3:].reshape(-1)}
            for i in range(n):
                got = ranks["coll"][n][gi * n + i][f"{key}_{transport}"]
                jw = want[gi * n + i]
                for k in ("a", "b"):
                    scale = np.abs(exact[k]).max()
                    rel = np.abs(got[k] - exact[k]).max() / scale
                    assert rel < TIERS[transport], (key, k, rel)
                    # one quantization step of JAX's own result at most
                    step = {"fp32": 1e-6, "bf16": 2 ** -7,
                            "int8": 2 / 127}[transport]
                    assert np.abs(got[k] - jw[k]).max() <= step * scale + \
                        1e-6, (key, k)


def test_int8_codes_and_scales_equal_jax():
    import torch
    rng = np.random.RandomState(3)
    rows = rng.standard_normal((4, 64)).astype(np.float32) * \
        np.array([[1.0], [1e-3], [50.0], [0.0]], np.float32)
    pc, ps = comm._quantize_rows(torch.from_numpy(rows), 16)
    jc, js = jcomm._quantize_rows(jnp.asarray(rows), 16)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    back = comm._dequantize_rows(pc, ps, 16)
    jback = jcomm._dequantize_rows(jc, js, 16)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    assert comm.quantized_chunk(1000, 4, 256) == \
        jcomm.quantized_chunk(1000, 4, 256)
    entries = [(k, s, dt) for k, s, dt in ENTRIES]
    assert [tuple(b) for b in comm.plan_buckets(entries, BUCKET_MB)] == \
        [tuple(b) for b in jcomm.plan_buckets(entries, BUCKET_MB)]
    for kind in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
                 "ppermute"):
        assert comm.ring_wire_bytes(kind, 1000, 4) == \
            jcomm.ring_wire_bytes(kind, 1000, 4)


@pytest.mark.parametrize("n", [4, 2])
def test_autograd_pairs_are_conjugate(ranks, n):
    """The forward collective and the gradient of ``sum(y * w)``:
    copy_to_group sums the gradient over the axis, reduce_from_group
    passes it through, gather/scatter pairs reduce-scatter and gather,
    split_to_group's gradient is every rank's slice gathered."""
    xs = _inputs()
    for gi, grp in enumerate(_groups(xs, n)):
        rs = ranks["coll"][n][gi * n:(gi + 1) * n]
        for i, r in enumerate(rs):
            def w(shape):
                return np.arange(np.prod(shape), dtype=np.float32).reshape(
                    shape) / 7.0
            y, g = r["pair_copy_to_group"]
            np.testing.assert_array_equal(y, grp[i])
            np.testing.assert_allclose(g, n * w((ROWS, 3)), rtol=1e-6)
            y, g = r["pair_reduce_from_group"]
            np.testing.assert_allclose(y, sum(grp), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(g, w((ROWS, 3)), rtol=1e-6)
            y, g = r["pair_gather_from_group"]
            np.testing.assert_allclose(y, np.concatenate(grp), rtol=1e-6)
            np.testing.assert_allclose(
                g, n * w((ROWS * n, 3))[ROWS * i:ROWS * (i + 1)], rtol=1e-6)
            y, g = r["pair_reduce_scatter_to_group"]
            c = ROWS // n
            np.testing.assert_allclose(y, sum(grp)[c * i:c * (i + 1)],
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(
                g, np.concatenate([w((c, 3))] * n), rtol=1e-6)
            y, g = r["pair_split_to_group"]
            np.testing.assert_array_equal(y, grp[i][c * i:c * (i + 1)])
            # the input is replicated: its gradient gathers every rank's
            np.testing.assert_allclose(
                g, np.concatenate([w((c, 3))] * n), rtol=1e-6)
            y, g = r["pair_gather_output"]
            np.testing.assert_allclose(y, np.concatenate(grp, 1), rtol=1e-6)
            np.testing.assert_allclose(
                g, w((ROWS, 3 * n))[:, 3 * i:3 * (i + 1)], rtol=1e-6)


def _pred_key(p):
    return (p["kind"], p["payload_bytes"], p["dtype"])


@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("layout", [lay[0] for lay in STATS_LAYOUTS])
def test_comm_stats_equal_the_predictions(ranks, n, layout):
    """The counterpart of the JAX package's prediction-vs-HLO check: the
    gradient-sync and parameter collectives one update issued, against
    ``predict_grad_comm_collectives`` (all-reduce path) or
    ``predict_flat_update_collectives`` (flat ZeRO-2/3)."""
    tr, kind = layout.split("_", 1)
    entries = [(i, s, dt) for i, (_, s, dt) in enumerate(ENTRIES)]
    if kind == "zero0":
        pred = dstates.predict_grad_comm_collectives(entries, n, BUCKET_MB,
                                                     tr)
        tags = ("grad_sync",)
    else:
        pred = dstates.predict_flat_update_collectives(
            entries, n, BUCKET_MB, tr, zero=int(kind[-1]))
        tags = ("grad_comm", "param_comm", "param_gather")
    recs = [r for r in ranks["stats"][n][layout]
            if r[5].split("/")[0] in tags]
    got = sorted((r[0], r[1], r[3]) for r in recs)
    assert got == sorted(_pred_key(p) for p in pred)
    assert len(recs) == len(pred) and len(pred) > 1
    for r in recs:
        assert r[2] == comm.ring_wire_bytes(r[0], r[1], n)
        assert not r[6]                   # CPU tensors: nothing staged


def _ce_reference(logits, labels):
    """The mean cross entropy over the valid tokens, in float64."""
    z = logits.astype(np.float64)
    z = z - z.max(-1, keepdims=True)
    lp = z - np.log(np.exp(z).sum(-1, keepdims=True))
    keep = labels != -100
    picked = np.take_along_axis(lp, np.where(keep, labels, 0)[..., None],
                                -1)[..., 0]
    return -(picked * keep).sum() / keep.sum()


@pytest.mark.parametrize("mesh_i", range(len(CE_MESHES)))
def test_cross_entropy_one_path_for_every_layout(ranks, mesh_i):
    """The mesh's cross entropy (vocab split over tp, the mean over the
    valid tokens of the global batch) against one process's on the
    global logits: the same dtype in every layout (a bf16 model's loss is
    bf16 with or without a mesh), the loss within 1e-6 in fp32 and
    within one bf16 step in bf16, of the one-process loss and of a
    float64 reference; the shards' gradients are the one-process
    gradient's (times dp).  The fp32 loss also equals the JAX package's
    (whose bf16 loss is NaN where labels are ignored: its gather reads
    index -100 before the mask)."""
    import torch

    import hetu_tpu as jht
    from hetu_tpu_torch import nn
    shape = CE_MESHES[mesh_i]
    dp, tp = shape.get("dp", 1), shape.get("tp", 1)
    logits, labels = _ce_inputs()
    rows, vocab = logits.shape[0] // dp, logits.shape[-1] // tp
    for dt, tol in (("float32", 1e-6), ("bfloat16", 2.0 ** -7)):
        lg = torch.from_numpy(logits).to(getattr(torch, dt))
        lg.requires_grad_(True)
        one = nn.vocab_parallel_cross_entropy(lg, torch.from_numpy(labels),
                                              ignore_index=-100)
        (g1,) = torch.autograd.grad(one, lg)
        one = float(one.detach())
        ref = _ce_reference(lg.detach().float().numpy(), labels)
        assert abs(one - ref) <= tol * ref
        if dt == "float32":
            jl = jht.ops.softmax_cross_entropy(
                jnp.asarray(logits), jnp.asarray(labels),
                ignore_index=-100).numpy()
            assert abs(one - float(jl)) <= tol * ref
        for r, res in enumerate(ranks["ce"][mesh_i]):
            loss, dtype, g = res[dt]
            assert dtype == f"torch.{dt}", (shape, r)
            assert abs(loss - one) <= tol * ref, (shape, r, loss, one)
            i, j = divmod(r, tp)
            # times dp: the optimizer averages the gradients over dp
            want = dp * g1.float().numpy()[i * rows:(i + 1) * rows, :,
                                           j * vocab:(j + 1) * vocab]
            np.testing.assert_allclose(g, want, rtol=0,
                                       atol=1e-7 if dt == "float32"
                                       else 2.0 ** -7 * np.abs(want).max())
