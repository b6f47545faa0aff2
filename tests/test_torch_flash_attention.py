"""The port's plain flash-attention versions against the JAX package's
Pallas kernels, which run in interpret mode on the CPU (as
tests/test_flash_attention.py runs them).

Inputs are fp32 from numpy seeds.  Forward ``(out, lse)`` within 1e-4
and backward ``(dq, dk, dv)`` within 1e-3 (the tolerances of
tests/test_flash_attention.py): both sides accumulate in fp32, in other
orders, and the JAX kernels work in base-2 logits with the scale folded
into q.  The bf16 cases hold the same pairs at the card gate's bf16
limit (``_bf16_limit_ratio``).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.ops.pallas import flash_attention as jfa
from hetu_tpu_torch.ops import flash_attention as pfa
from hetu_tpu_torch.ops.attention import sdpa, sdpa_reference

# (name, b, sq, sk, h, d, causal, segments, causal_offset)
#   segments: None, "array" (shared [b, s] ids) or "tuple" ((q_ids, kv_ids))
FWD_CASES = [
    ("causal", 2, 128, 128, 2, 64, True, None, 0),
    ("full", 2, 128, 128, 2, 64, False, None, 0),
    ("segments_array", 2, 128, 128, 2, 64, True, "array", 0),
    ("segments_tuple_offset", 1, 64, 128, 2, 64, True, "tuple", 64),
    ("fully_masked_rows", 2, 128, 128, 2, 64, True, "masked", 0),
    ("s96", 2, 96, 96, 2, 64, True, None, 0),
    ("s384_three_blocks", 1, 384, 384, 2, 64, True, None, 0),
    ("d128", 1, 128, 128, 2, 128, True, None, 0),
]


def _inputs(b, sq, sk, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, h, d).astype(np.float32),
            rng.randn(b, sk, h, d).astype(np.float32),
            rng.randn(b, sk, h, d).astype(np.float32),
            rng.randn(b, sq, h, d).astype(np.float32))


def _segments(kind, b, sq, sk):
    """numpy segment ids of one kind: 4 packed documents; a tuple whose
    q rows are the last sq of the kv axis; or padding rows (id 7 on the
    q side that no key has) for the fully-masked contract."""
    if kind is None:
        return None
    if kind == "array":
        return np.repeat(np.arange(4), sq // 4)[None].repeat(b, 0) \
            .astype(np.int32)
    kv = np.repeat(np.arange(2), sk // 2)[None].repeat(b, 0).astype(np.int32)
    if kind == "tuple":
        return kv[:, sk - sq:].copy(), kv
    q = kv[:, :sq].copy()
    q[:, sq // 2:] = 7
    return q, kv


def _to_jax(segs):
    if segs is None:
        return None
    if isinstance(segs, tuple):
        return tuple(jnp.asarray(s) for s in segs)
    return jnp.asarray(segs)


def _to_torch(segs):
    if segs is None:
        return None
    if isinstance(segs, tuple):
        return tuple(torch.from_numpy(s) for s in segs)
    return torch.from_numpy(segs)


def _case(case):
    name, b, sq, sk, h, d, causal, seg_kind, offset = case
    q, k, v, do = _inputs(b, sq, sk, h, d)
    segs = _segments(seg_kind, b, sq, sk)
    return q, k, v, do, segs, causal, offset, 1.0 / np.sqrt(d)


@pytest.mark.parametrize("case", FWD_CASES, ids=[c[0] for c in FWD_CASES])
def test_forward_matches_jax_kernel(case):
    q, k, v, _, segs, causal, offset, scale = _case(case)
    jo, jl = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            scale, causal, _to_jax(segs), offset)
    po, pl = pfa.flash_fwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale, causal, _to_torch(segs), offset)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=1e-4,
                               atol=1e-4)
    jl = np.asarray(jl)
    np.testing.assert_array_equal(np.isinf(pl.numpy()), np.isinf(jl))
    live = np.isfinite(jl)
    np.testing.assert_allclose(pl.numpy()[live], jl[live], rtol=1e-4,
                               atol=1e-4)
    if case[7] == "masked":
        # the padding rows: out = 0 and lse = -inf, on both sides
        assert np.all(pl.numpy()[:, :, case[2] // 2:] == -np.inf)
        assert np.all(po.numpy()[:, case[2] // 2:] == 0)


@pytest.mark.parametrize("kernel", ["fused", "split"])
@pytest.mark.parametrize("case", FWD_CASES[:6], ids=[c[0] for c in
                                                     FWD_CASES[:6]])
def test_backward_matches_jax_kernels(case, kernel):
    q, k, v, do, segs, causal, offset, scale = _case(case)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jl = jfa._flash_fwd(jq, jk, jv, scale, causal, _to_jax(segs), offset)
    bwd = jfa._flash_bwd_fused if kernel == "fused" else jfa._flash_bwd_split
    want = bwd(scale, causal, _to_jax(segs), (jq, jk, jv, jo, jl), jdo,
               offset)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = pfa.flash_fwd_reference(tq, tk, tv, scale, causal,
                                       _to_torch(segs), offset)
    got = pfa.flash_bwd_reference(tq, tk, tv, out, lse, tdo, scale, causal,
                                  _to_torch(segs), offset)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-3, err_msg=name)
    if case[7] == "masked":
        assert np.all(got[0].numpy()[:, case[2] // 2:] == 0)


# bf16 inputs: (name, b, s, h, d, segments); causal, sq == sk
BF16_CASES = [
    ("causal_s200_d128", 1, 200, 2, 128, None),
    ("segments_tuple_s384_d64", 1, 384, 2, 64, "tuple"),
]


def _bf16_limit_ratio(got, want, dims):
    """Largest |got - want| over the card gate's bf16 limit: 2**-7 *
    |want| + rms(want over ``dims``) / 32 + 2**-16 * rms(want).  The
    Pallas kernels round q * scale * log2(e), p and ds to bf16 before
    their products (flash_attention.py:274, :249, :377, :383); the plain
    versions keep every product in fp32, so this is the distance between
    the two roundings that the card kernels are allowed."""
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    rms = np.sqrt((w ** 2).mean(axis=dims, keepdims=True))
    limit = 2.0 ** -7 * np.abs(w) + rms / 32 + \
        2.0 ** -16 * np.sqrt((w ** 2).mean())
    return float((np.abs(g - w) / np.maximum(limit, 1e-30)).max())


@pytest.mark.parametrize("kernel", ["forward", "fused", "split"])
@pytest.mark.parametrize("case", BF16_CASES, ids=[c[0] for c in BF16_CASES])
def test_plain_versions_match_jax_kernels_in_bf16(case, kernel):
    """bf16 q/k/v/do (values exact in bf16, from numpy): the plain
    versions against the interpret-mode Pallas kernels, each output row
    (a query's out/dq, a key's dk/dv) within the card gate's bf16 limit.
    Both backward versions get the Pallas forward's out and lse."""
    _, b, s, h, d, seg_kind = case
    q, k, v, do = (torch.from_numpy(x).bfloat16()
                   for x in _inputs(b, s, s, h, d, seed=3))
    segs = _segments(seg_kind, b, s, s)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                       for x in (q, k, v, do))
    jo, jl = jfa._flash_fwd(jq, jk, jv, scale, True, _to_jax(segs), 0)
    if kernel == "forward":
        po, pl = pfa.flash_fwd_reference(q, k, v, scale, True,
                                         _to_torch(segs))
        assert po.dtype == torch.bfloat16
        assert _bf16_limit_ratio(po.float(), np.asarray(jo, np.float32),
                                 (3,)) <= 1.0
        # lse moves with the bf16 rounding of q * scale * log2(e): 2**-9
        # of each score, a few thousandths for these scores of size ~5
        jl = np.asarray(jl)
        np.testing.assert_array_equal(np.isinf(pl.numpy()), np.isinf(jl))
        live = np.isfinite(jl)
        np.testing.assert_allclose(pl.numpy()[live], jl[live], rtol=1e-2,
                                   atol=1e-2)
        return
    bwd = jfa._flash_bwd_fused if kernel == "fused" else jfa._flash_bwd_split
    want = bwd(scale, True, _to_jax(segs), (jq, jk, jv, jo, jl), jdo, 0)
    out = torch.from_numpy(np.asarray(jo, np.float32)).bfloat16()
    lse = torch.from_numpy(np.array(jl, np.float32))
    got = pfa.flash_bwd_reference(q, k, v, out, lse, do, scale, True,
                                  _to_torch(segs))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16, name
        ratio = _bf16_limit_ratio(g.float(), np.asarray(w, np.float32),
                                  (3,))
        assert ratio <= 1.0, (name, ratio)


def test_autograd_function_uses_the_plain_backward():
    q, k, v, do, segs, causal, offset, scale = _case(FWD_CASES[2])
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    seg_t = torch.from_numpy(segs)
    out = pfa.flash_attention(tq, tk, tv, causal=True, segment_ids=seg_t)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    ro, rl = pfa.flash_fwd_reference(tq.detach(), tk.detach(), tv.detach(),
                                     scale, True, seg_t)
    want = pfa.flash_bwd_reference(tq.detach(), tk.detach(), tv.detach(),
                                   ro, rl, torch.from_numpy(do), scale, True,
                                   seg_t)
    np.testing.assert_array_equal(out.detach().numpy(), ro.numpy())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    # the segment ids are an input without a gradient: _Flash.backward
    # returns None in their slot
    assert seg_t.grad is None and not seg_t.requires_grad
    ctx = types.SimpleNamespace(saved_tensors=(tq.detach(), tk.detach(),
                                               tv.detach(), ro, rl),
                                segment_ids=seg_t, scale=scale, causal=True)
    slots = pfa._Flash.backward(ctx, torch.from_numpy(do))
    assert slots[3] is None
    for g, w in zip(slots[:3], want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("sk,d,dtype", [
    (1024, 64, torch.bfloat16), (4096, 64, torch.bfloat16),
    (4096, 64, torch.float32), (4096, 128, torch.bfloat16),
    (4096, 128, torch.float32), (2048, 128, torch.float32),
    (2049, 128, torch.float32), (2730, 128, torch.bfloat16),
    (2731, 128, torch.bfloat16),
    (8192, 64, torch.bfloat16), (8192, 64, torch.float32)])
def test_fused_split_choice_equals_jax_rule(sk, d, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jax_fused = 2 * sk * d * (4 + jnp.dtype(jdt).itemsize) \
        <= jfa._FUSED_DKV_VMEM_BYTES
    assert pfa._use_fused(sk, d, dtype) == jax_fused


def test_sdpa_routes_cpu_tensors_to_the_plain_version():
    q, k, v, _ = _inputs(1, 32, 32, 2, 64)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want = sdpa_reference(tq, tk, tv, causal=True)
    np.testing.assert_array_equal(sdpa(tq, tk, tv).numpy(), want.numpy())
    # use_flash=True on the CPU: the flash autograd function, plain inside
    flash = sdpa(tq, tk, tv, use_flash=True)
    np.testing.assert_allclose(flash.numpy(), want.numpy(), atol=1e-5)
    # a bias always takes the plain version
    bias = torch.zeros(1, 2, 32, 32)
    np.testing.assert_array_equal(
        sdpa(tq, tk, tv, bias=bias, use_flash=True).numpy(), want.numpy())


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, _ = _inputs(1, 64, 64, 2, 64)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with pytest.raises(ValueError, match="one CUDA device"):
        pfa.flash_fwd_cuda(tq, tk, tv, 0.125, True)
    with pytest.raises(ValueError, match="head_dim 32 not supported"):
        pfa.flash_fwd_cuda(tq[..., :32], tk[..., :32], tv[..., :32],
                           0.125, True)
    with pytest.raises(ValueError, match="dtypes"):
        pfa.flash_fwd_cuda(tq.bfloat16(), tk, tv, 0.125, True)
