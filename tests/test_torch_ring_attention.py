"""The port's ring attention (``hetu_tpu_torch.parallel.ring_attention``)
against the JAX package, on the CPU.

The port's side runs on gloo ranks (tests/torch_ranks.py, cp 2 and cp
4, and ``{"cp": 2, "tp": 2}``), each on its contiguous shard of one set
of seeded global inputs; the parent puts the shards together and holds
them against JAX's ``ring_attention_sharded`` on a JAX ``{"cp": 2}`` /
``{"cp": 4}`` mesh of the virtual CPU devices (normal and sym splits,
causal and not, packed segments, per-rank ``seq_lens``, bf16), and the
gradients against ``jax.vjp`` of ``sdpa_reference`` over the global
sequence with the same segments (padding as ids no other token has, its
rows' cotangent zero, so the ring's and the dense masks agree).  The
host helpers must equal JAX's exactly.  Tolerances: 2e-5 in fp32; in
bf16 one bf16 ulp of the value plus 1/32 of the row's RMS (ROADMAP "How
the port is held").
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hetu_tpu.ops.attention import sdpa_reference
from torch_ranks import run_ranks

jra = importlib.import_module("hetu_tpu.parallel.ring_attention")
pra = importlib.import_module("hetu_tpu_torch.parallel.ring_attention")

TOL = 2e-5
B, S, H, D = 2, 64, 2, 16


def _inputs(seed=0, h=H):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((B, S, h, D)).astype(np.float32)
            for _ in range(4)]


Q, K, V, DO = _inputs()
DOCS = np.zeros((B, S), np.int32)      # boundaries off the blocks' edges
DOCS[:, 21:43] = 1
DOCS[:, 43:] = 2
DOCS[1, 9:] = 5
PADDED_DOCS = DOCS.copy()
PADDED_DOCS[0, 58:] = -1                # padding inside rank 3's block
LENS4 = [16, 9, 16, 12]                 # per-rank valid lengths (cp 4)
LENS2 = [32, 20]


def _valid(cp, lens, pattern):
    """[S] bool: positions a per-rank length keeps, in global order (the
    lengths count in each rank's own block, reordered under sym)."""
    s_local = S // cp
    pos = np.arange(S)
    valid_r = (pos % s_local) < np.asarray(lens)[pos // s_local]
    if pattern != "sym":
        return valid_r
    valid = np.empty(S, bool)
    valid[jra.sym_indices(S, cp)] = valid_r
    return valid


def _oracle_segments(segs, valid=None):
    """The ring's padding (-1, and positions past a rank's length) as ids
    no other token has, for the dense oracle."""
    segs = np.zeros((B, S), np.int32) if segs is None else segs.copy()
    pad = segs < 0
    if valid is not None:
        pad |= ~valid[None, :]
    return np.where(pad, -1000 - np.arange(S)[None, :], segs), pad


# (name, cp, causal, pattern, segments, seq_lens, dtype, with grads,
#  against JAX's ring): the JAX ring runs ~3 s a call in interpret mode,
# so six of these are held against it; the rest against the dense oracle
CASES = [
    ("cp2_normal_causal", 2, True, "normal", None, None, "float32", True,
     True),
    ("cp4_sym_packed", 4, True, "sym", DOCS, None, "float32", True, True),
    ("cp4_normal_full", 4, False, "normal", None, None, "float32", True,
     True),
    ("cp4_normal_lens_packed", 4, True, "normal", PADDED_DOCS, LENS4,
     "float32", True, True),
    ("cp2_sym_lens", 2, True, "sym", None, LENS2, "float32", True, True),
    ("cp4_normal_bf16", 4, True, "normal", None, None, "bfloat16", False,
     True),
    ("cp2_sym_full", 2, False, "sym", DOCS, None, "float32", True, False),
    ("cp4_sym_lens_padded", 4, True, "sym", PADDED_DOCS, LENS4, "float32",
     True, False),
    ("cp2_normal_packed", 2, True, "normal", PADDED_DOCS, None, "float32",
     True, False),
    ("cp2_sym_bf16", 2, True, "sym", DOCS, None, "bfloat16", False, False),
]


def _cotangent(case):
    """DO with the padded rows zeroed (see the module docstring)."""
    name, cp, causal, pattern, segs, lens = case[:6]
    valid = _valid(cp, lens, pattern) if lens is not None else None
    _, pad = _oracle_segments(segs, valid)
    return np.where(pad[:, :, None, None], 0.0, DO).astype(np.float32)


def _job(case):
    name, cp, causal, pattern, segs, lens, dtype, grads, _ = case
    return dict(name=name, mesh={"cp": cp}, q=Q, k=K, v=V,
                do=_cotangent(case) if grads else None, causal=causal,
                pattern=pattern, segment_ids=segs, seq_lens=lens,
                dtype=dtype)


def _assemble(per_rank, j, shape=(B, S, H, D)):
    """Job ``j``'s shards put together: (out, [dq, dk, dv] or None,
    dtype, each rank's records)."""
    out = np.zeros(shape, np.float32)
    grads = None
    for r in per_rank:
        res = r[j]
        assert "error" not in res, res["error"]
        sl = (slice(*res["b"]), slice(*res["s"]), slice(*res["h"]))
        out[sl] = res["out"]
        if "grads" in res:
            if grads is None:
                grads = [np.zeros(shape, np.float32) for _ in range(3)]
            for g, x in zip(grads, res["grads"]):
                g[sl] = x
    return out, grads, per_rank[0][j]["dtype"], \
        [r[j]["records"] for r in per_rank]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case on its gloo ranks: cp 2 cases and the profile on 2
    ranks, cp 4 cases and the tp case on 4 (one launch each)."""
    tmp = tmp_path_factory.mktemp("ring")
    out = {}
    for world in (2, 4):
        cases = [c for c in CASES if c[1] == world]
        jobs = [("cp_attention", {"jobs": [_job(c) for c in cases]})]
        if world == 2:
            jobs.append(("ring_profile", dict(
                q=Q, k=K, v=V, path=str(tmp / "ring_profile.jsonl"))))
        else:
            jobs.append(("cp_attention", {"jobs": [dict(
                name="cp2_tp2", mesh={"cp": 2, "tp": 2}, q=Q, k=K, v=V,
                do=DO, causal=True, pattern="sym", segment_ids=DOCS)]}))
        res = run_ranks("many", world, {"jobs": jobs}, tmp, timeout=150.0)
        for j, c in enumerate(cases):
            out[c[0]] = _assemble([r[0] for r in res], j)
        if world == 2:
            out["profile"] = [r[1] for r in res]
        else:
            out["cp2_tp2"] = _assemble([r[1] for r in res], 0)
    return out


def _jax_mesh(cp):
    from hetu_tpu.parallel import create_mesh
    return create_mesh({"cp": cp}, jax.devices()[:cp])


def _bf16_rows_ok(got, want):
    """ROADMAP's bf16 row rule: |got - want| <= 2**-7 |want| + 1/32 of
    the RMS of want's row (over the head dim)."""
    rms = np.sqrt(np.mean(want.astype(np.float64) ** 2, axis=-1,
                          keepdims=True))
    return np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + rms / 32)


def _as(dtype, x):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16"
                       else jnp.float32)


@pytest.mark.parametrize("case", [c for c in CASES if c[8]],
                         ids=[c[0] for c in CASES if c[8]])
def test_forward_matches_jax_ring(port, case):
    name, cp, causal, pattern, segs, lens, dtype = case[:7]
    got, _, got_dtype, _ = port[name]
    want = jra.ring_attention_sharded(
        _as(dtype, Q), _as(dtype, K), _as(dtype, V), _jax_mesh(cp),
        causal=causal, batch_axis=None, head_axis=None,
        split_pattern=pattern,
        segment_ids=None if segs is None else jnp.asarray(segs),
        seq_lens=None if lens is None else np.asarray(lens, np.int32))
    want = np.asarray(want, np.float32)
    assert got_dtype == ("torch.bfloat16" if dtype == "bfloat16"
                         else "torch.float32")
    if dtype == "bfloat16":
        assert _bf16_rows_ok(got, want), np.abs(got - want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _dense(case, q=Q, k=K, v=V):
    """Out and the grads of sum(out * do) of the dense oracle."""
    name, cp, causal, pattern, segs, lens, dtype = case[:7]
    valid = _valid(cp, lens, pattern) if lens is not None else None
    oseg, pad = _oracle_segments(segs, valid)
    seg_arg = None if segs is None and lens is None else jnp.asarray(oseg)

    def f(q, k, v):
        return sdpa_reference(_as(dtype, q), _as(dtype, k), _as(dtype, v),
                              causal=causal,
                              segment_ids=seg_arg).astype(jnp.float32)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp(jnp.asarray(_cotangent(case)))
    return np.asarray(out), [np.asarray(g) for g in grads], pad


@pytest.mark.parametrize("case", [c for c in CASES if c[7]],
                         ids=[c[0] for c in CASES if c[7]])
def test_grads_match_dense_vjp(port, case):
    """dq, dk, dv of both splits, with segments and per-rank lengths,
    against ``jax.vjp`` of the dense reference; the forward's valid rows
    too (padded rows give 0 in the ring)."""
    got, grads, _, _ = port[case[0]]
    want, want_grads, pad = _dense(case)
    np.testing.assert_allclose(got[~pad], want[~pad], rtol=0, atol=TOL)
    assert not np.any(got[pad])
    for name, g, w in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL,
                                   err_msg=f"d{name} of {case[0]}")


def test_bf16_sym_packed_against_dense(port):
    """bf16 under the sym split with packed segments: against the fp32
    dense reference of the same bf16 inputs, by the bf16 row rule."""
    got, _, got_dtype, _ = port["cp2_sym_bf16"]
    assert got_dtype == "torch.bfloat16"
    rounded = [np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
               for x in (Q, K, V)]
    want = np.asarray(sdpa_reference(*(jnp.asarray(x) for x in rounded),
                                     causal=True,
                                     segment_ids=jnp.asarray(DOCS)))
    assert _bf16_rows_ok(got, want), np.abs(got - want).max()


def test_heads_split_over_tp_with_sym_and_segments(port):
    """``{"cp": 2, "tp": 2}``: each rank holds its heads' shard; sym split
    and packed segments; out and grads against the dense oracle."""
    got, grads, _, _ = port["cp2_tp2"]
    case = ("cp2_tp2", 2, True, "sym", DOCS, None, "float32")
    want, want_grads, _ = _dense(case)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


@pytest.mark.parametrize("name,cp,segs,sym", [
    ("cp2_normal_causal", 2, False, False), ("cp4_sym_packed", 4, True, True),
    ("cp4_normal_lens_packed", 4, True, False)])
def test_hops_on_the_ring(port, name, cp, segs, sym):
    """The forward moves k, v (and the ids with segments) ``cp - 1``
    times, the backward the same again and dk, dv ``cp`` times; the sym
    layout's exchange is two hops of q, k and v each way (and of the ids
    in), and their reverse in the backward."""
    for rec in port[name][3]:
        kv = sum(1 for r in rec if r[0] == "ppermute" and r[5] == "ring/kv")
        dkv = sum(1 for r in rec
                  if r[0] == "ppermute" and r[5] == "ring/dkv")
        lay = sum(1 for r in rec
                  if r[0] == "ppermute" and r[5] == "ring/sym_layout")
        per = 3 if segs else 2
        assert kv == 2 * (cp - 1) * per
        assert dkv == 2 * cp
        # q, k, v in (and their grads back), the ids in, the out back
        # (and its grad in): two halves each
        assert lay == (2 * (3 + 3 + 1 + 1) + (2 if segs else 0)
                       if sym else 0)


@pytest.mark.parametrize("cp", [2, 4])
def test_helpers_equal_jax(cp):
    for s in (4 * cp, 16 * cp):
        np.testing.assert_array_equal(pra.sym_indices(s, cp),
                                      jra.sym_indices(s, cp))
        np.testing.assert_array_equal(pra.sym_inverse_indices(s, cp),
                                      jra.sym_inverse_indices(s, cp))
    for pattern in ("normal", "sym"):
        for causal in (True, False):
            np.testing.assert_array_equal(
                pra.pair_score_area(cp, pattern, causal),
                jra.pair_score_area(cp, pattern, causal))
            for my in range(cp):
                for kv in range(cp):
                    assert pra._mask_kind(my, kv, causal, pattern) == \
                        int(jra._mask_kind(jnp.int32(my), jnp.int32(kv),
                                           causal, pattern))
    assert (pra.CAUSAL, pra.FULL, pra.EMPTY, pra.CAUSAL_SYM, pra.COL,
            pra.ROW) == (jra.CAUSAL, jra.FULL, jra.EMPTY, jra.CAUSAL_SYM,
                         jra.COL, jra.ROW)


def test_sym_exchange_equals_the_global_reorder():
    """The sym permutations move every chunk where ``sym_indices`` puts
    it, and the global reorder round-trips."""
    import torch
    for cp in (1, 2, 3, 4, 8):
        s = 4 * cp
        ch = s // (2 * cp)
        order = pra.sym_indices(s, cp)
        for h, perm in enumerate(pra.sym_perms(cp)):
            assert sorted(d for _, d in perm) == list(range(cp))
            for i, j in perm:
                c = 2 * i + h                  # the chunk half h holds
                block = order[j * 2 * ch:(j + 1) * 2 * ch]
                assert c * ch in block
        x = torch.arange(2 * s * 3).reshape(2, s, 3)
        assert torch.equal(pra.sym_unshard(pra.sym_shard(x, cp), cp), x)
        np.testing.assert_array_equal(
            pra.sym_shard(x, cp).numpy(),
            np.asarray(jra.sym_shard(jnp.asarray(x.numpy()), cp)))


def test_merge_keeps_empty_rows_finite():
    """A row empty in one round, or in every round, merges to out = 0 and
    no NaN (the guards against -inf)."""
    import torch
    b, s, h, d = 1, 3, 1, 2
    acc = pra._init_acc(b, s, h, d, "cpu")
    o1 = torch.tensor([[[[1.0, 2.0]], [[3.0, 4.0]], [[0.0, 0.0]]]])
    l1 = torch.tensor([[[0.5, float("-inf"), float("-inf")]]])
    acc = pra._merge(acc, o1, l1)
    o2 = torch.tensor([[[[5.0, 6.0]], [[7.0, 8.0]], [[0.0, 0.0]]]])
    l2 = torch.tensor([[[float("-inf"), 0.25, float("-inf")]]])
    m, denom, out = pra._merge(acc, o2, l2)
    assert torch.isfinite(out).all() and torch.isfinite(denom).all()
    np.testing.assert_allclose(out[0, 0, 0].numpy(), [1.0, 2.0])
    np.testing.assert_allclose(out[0, 1, 0].numpy(), [7.0, 8.0])
    assert float(denom[0, 0, 2]) == 0.0 and not out[0, 2].any()


def test_profile_breakdown_rows_and_hook(port):
    """``profile_ring_breakdown`` gives one row a round with all four
    timings and records the CP table through ``Metrics``; the
    ``HETU_TPU_RING_PROFILE`` hook fires once per shape (a second call at
    one shape adds nothing), writing each rank's rounds to its file."""
    for prof in port["profile"]:
        assert [r["round"] for r in prof["rows"]] == [0, 1]
        for row in prof["rows"]:
            for key in ("comm_s", "attn_s", "corr_s", "grad_s"):
                assert row[key] > 0.0
        assert prof["series"] == {"ring_comm_s": 2, "ring_attn_s": 2,
                                  "ring_corr_s": 2, "ring_grad_s": 2}
        assert prof["keys_after_two"] == 1 and prof["keys"] == 2
        assert [ln["step"] for ln in prof["lines"]] == [0, 1, 0, 1]
        for ln in prof["lines"]:
            assert set(ln) == {"step", "ring_comm_s", "ring_attn_s",
                               "ring_corr_s"}


def test_ring_refusals():
    import torch
    from hetu_tpu_torch.parallel import ring_attention
    q = torch.zeros((1, 6, 1, 4))
    with pytest.raises(ValueError, match="needs a mesh"):
        ring_attention(q, q, q)
    from hetu_tpu_torch.parallel.mesh import Mesh
    with Mesh({"cp": 1}, device="cpu"):
        with pytest.raises(ValueError, match="split_pattern"):
            ring_attention(q, q, q, split_pattern="zigzag")
        with pytest.raises(ValueError, match="even local seq"):
            ring_attention(q[:, :5], q[:, :5], q[:, :5],
                           split_pattern="sym")
        # cp 1: the ring is one pair, flash attention itself
        x = torch.randn((1, 6, 2, 4))
        got = ring_attention(x, x, x, causal=True)
        from hetu_tpu_torch.ops.attention import sdpa_reference as tref
        np.testing.assert_allclose(got.numpy(), tref(x, x, x).numpy(),
                                   atol=TOL)
