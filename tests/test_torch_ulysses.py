"""The port's Ulysses attention (``hetu_tpu_torch.parallel.ulysses``)
against the JAX package, on the CPU.

Four gloo ranks (tests/torch_ranks.py) each run their shard of seeded
global ``[b, s, h, d]`` inputs (the sequence over ``cp``, the heads over
``tp``); the parent puts the shards together and holds them against
JAX's ``ulysses_attention_sharded`` on a JAX mesh of the virtual CPU
devices: packed segments at cp 4, a head count cp does not divide
(zero-padded, then sliced off) at cp 4 and at cp 2 x tp 2, and the
gradients against ``jax.vjp`` of the dense ``sdpa_reference``; the
refusals (GQA kv heads unequal to q heads, heads cp does not divide in
the unpadded op) are JAX's.  Tolerance 2e-5 (fp32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hetu_tpu.ops.attention import sdpa_reference
from hetu_tpu.parallel.ulysses import ulysses_attention_sharded
from torch_ranks import run_ranks

TOL = 2e-5
B, S, D = 2, 64, 16


def _qkv(h, seed, kv_h=None):
    rng = np.random.RandomState(seed)
    kv_h = kv_h or h
    return (rng.standard_normal((B, S, h, D)).astype(np.float32),
            rng.standard_normal((B, S, kv_h, D)).astype(np.float32),
            rng.standard_normal((B, S, kv_h, D)).astype(np.float32),
            rng.standard_normal((B, S, h, D)).astype(np.float32))


DOCS = np.repeat(np.arange(4), 16)[None, :].repeat(B, 0).astype(np.int32)
DOCS[1, 40:] = 7                     # a boundary inside a cp-4 block
# (name, mesh, heads, kv heads, impl, segments, seed)
CASES = [
    ("cp4_packed", {"cp": 4}, 8, None, "ulysses", DOCS, 3),
    ("cp4_heads6_padded", {"cp": 4}, 6, None, "ulysses", None, 4),
    ("cp2_tp2_heads6_padded", {"cp": 2, "tp": 2}, 6, None, "ulysses", None,
     5),
    ("cp4_gqa_refused", {"cp": 4}, 8, 2, "ulysses", None, 6),
    ("cp4_heads6_unpadded_refused", {"cp": 4}, 6, None, "ulysses_local",
     None, 7),
]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ulysses")
    jobs = []
    for name, mesh, h, kv_h, impl, segs, seed in CASES:
        q, k, v, do = _qkv(h, seed, kv_h)
        jobs.append(dict(name=name, mesh=mesh, q=q, k=k, v=v,
                         do=None if kv_h else do, impl=impl,
                         segment_ids=segs, causal=True))
    res = run_ranks("cp_attention", 4, {"jobs": jobs}, tmp, timeout=150.0)
    out = {}
    for j, (name, mesh, h, kv_h, *_rest) in enumerate(CASES):
        if "error" in res[0][j]:
            out[name] = {"errors": [r[j]["error"] for r in res]}
            continue
        full = np.zeros((B, S, h, D), np.float32)
        grads = [np.zeros_like(full) for _ in range(3)]
        for r in res:
            x = r[j]
            sl = (slice(*x["b"]), slice(*x["s"]), slice(*x["h"]))
            full[sl] = x["out"]
            for g, part in zip(grads, x["grads"]):
                g[sl] = part
        out[name] = {"out": full, "grads": grads,
                     "records": [r[j]["records"] for r in res]}
    return out


def _jax_mesh(shape):
    from hetu_tpu.parallel import create_mesh
    n = int(np.prod(list(shape.values())))
    return create_mesh(shape, jax.devices()[:n])


@pytest.mark.parametrize("case", CASES[:3], ids=[c[0] for c in CASES[:3]])
def test_matches_jax_ulysses_and_dense_grads(port, case):
    name, mesh, h, _, _, segs, seed = case
    q, k, v, do = _qkv(h, seed)
    got = port[name]
    want = ulysses_attention_sharded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), _jax_mesh(mesh),
        causal=True, batch_axis=None,
        head_axis="tp" if "tp" in mesh else None,
        segment_ids=None if segs is None else jnp.asarray(segs))
    np.testing.assert_allclose(got["out"], np.asarray(want), rtol=0,
                               atol=TOL)
    seg_arg = None if segs is None else jnp.asarray(segs)
    _, vjp = jax.vjp(lambda q, k, v: sdpa_reference(
        q, k, v, causal=True, segment_ids=seg_arg), jnp.asarray(q),
        jnp.asarray(k), jnp.asarray(v))
    for n, g, w in zip("qkv", got["grads"], vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=TOL,
                                   err_msg=f"d{n}")


def test_all_to_alls_a_call(port):
    """Forward: q, k, v and the output each one all-to-all over cp, the
    segment ids one all-gather; backward: the four reverse all-to-alls,
    under the same tag."""
    for rec in port["cp4_packed"]["records"]:
        a2a = [r for r in rec if r[0] == "all_to_all"]
        assert len(a2a) == 8 and all(r[5] == "ulysses" and r[4] == "cp"
                                     for r in a2a)
        assert sum(1 for r in rec if r[0] == "all_gather") == 1
        assert not any(r[0] == "ppermute" for r in rec)


@pytest.mark.parametrize("name,jax_kw", [
    ("cp4_gqa_refused", dict(h=8, kv_h=2)),
    ("cp4_heads6_unpadded_refused", dict(h=6, kv_h=None))])
def test_refusals_are_jax_errors(port, name, jax_kw):
    """GQA kv heads unequal to q heads raise JAX's ValueError in the
    sharded op; heads cp does not divide raise it in the unpadded op."""
    errors = port[name]["errors"]
    assert all(e == errors[0] for e in errors)
    kind, msg = errors[0]
    assert kind == "ValueError"
    q, k, v, _ = _qkv(jax_kw["h"], 0, jax_kw["kv_h"])
    with pytest.raises(ValueError) as jerr:
        if name == "cp4_gqa_refused":
            ulysses_attention_sharded(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), _jax_mesh({"cp": 4}),
                                      batch_axis=None, head_axis=None)
        else:
            from hetu_tpu.parallel.comm import shard_map
            from hetu_tpu.parallel.ulysses import ulysses_attention
            from jax.sharding import PartitionSpec as P
            spec = P(None, "cp", None, None)
            shard_map(lambda q, k, v: ulysses_attention(q, k, v, "cp"),
                      _jax_mesh({"cp": 4}), (spec,) * 3, spec)(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    # the port's names the local head counts, JAX's the same words
    assert msg.split(" (")[0] == str(jerr.value).split(" (")[0]
