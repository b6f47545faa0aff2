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


# the split backward's cases besides FWD_CASES[:6]: the tile edges of the
# card's split dq kernel, whose blocks take 128 q rows (three of them at s
# 384, one row past a 64-row half and a ragged tile at sq 200) at head dims
# 64 and 128
SPLIT_CASES = [c for c in FWD_CASES if c[0] in ("s384_three_blocks",
                                                "d128")] + [
    ("causal_s200", 1, 200, 200, 2, 64, True, None, 0)]
BWD_CASES = [pytest.param(c, k, id=f"{c[0]}-{k}")
             for c in FWD_CASES[:6] for k in ("fused", "split")] + [
    pytest.param(c, "split", id=f"{c[0]}-split") for c in SPLIT_CASES]


@pytest.mark.parametrize("case,kernel", BWD_CASES)
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
    # every head dim runs on the card (above 256 on the wide route), so a
    # wide one on the CPU is refused for its device alone
    wide = tq.new_zeros(tq.shape[:3] + (264,))
    with pytest.raises(ValueError, match="one CUDA device"):
        pfa.flash_fwd_cuda(wide, wide, wide, 0.125, True)
    with pytest.raises(ValueError, match="dtypes"):
        pfa.flash_fwd_cuda(tq.bfloat16(), tk, tv, 0.125, True)


@pytest.mark.parametrize("route,counts", [
    (0, (1, 0, 0, 0)),     # the wide route's CUDA cores
    (1, (1, 1, 0, 0)),     # bf16 mma.sync
    (2, (1, 1, 1, 0)),     # 3xTF32
    (3, (1, 1, 0, 1)),     # bf16 wgmma
    (-1, (1, 0, 0, 0)),    # no route (never launched by the wrappers)
])
def test_count_launch_follows_the_route_the_library_reports(route, counts):
    """``_count_launch`` adds one launch and counts it on the route that
    ``hetu_flash_uses_tensor_cores`` reports for the entry, head dim and
    type code (here a stand-in library, on the CPU)."""
    asked = []

    class Lib:
        def hetu_flash_uses_tensor_cores(self, entry, d, code):
            asked.append((entry, d, code))
            return route

    def wrapper():
        pass
    wrapper.launches = wrapper.tensor_core_launches = 0
    wrapper.tf32_launches = wrapper.wgmma_launches = 0
    pfa._count_launch(wrapper, Lib(), pfa._ENTRY_DKV, 128, 1)
    assert asked == [(pfa._ENTRY_DKV, 128, 1)]
    assert (wrapper.launches, wrapper.tensor_core_launches,
            wrapper.tf32_launches, wrapper.wgmma_launches) == counts


@pytest.mark.parametrize("causal", [False, True])
def test_count_launch_counts_causal_launches_apart(causal):
    """A causal launch adds one to ``causal_launches`` too, so a path's
    non-causal launches are ``launches - causal_launches``."""
    class Lib:
        def hetu_flash_uses_tensor_cores(self, entry, d, code):
            return 3

    def wrapper():
        pass
    for name in pfa._COUNTS:
        setattr(wrapper, name, 0)
    pfa._count_launch(wrapper, Lib(), pfa._ENTRY_FWD, 64, 1, causal)
    assert (wrapper.launches, wrapper.causal_launches) == (1, int(causal))
    for fn in (pfa.flash_fwd_cuda, pfa.flash_bwd_fused_cuda,
               pfa.flash_bwd_dq_cuda, pfa.flash_bwd_dkv_cuda):
        assert hasattr(fn, "causal_launches")


def test_every_wrapper_counts_wgmma_launches():
    for fn in (pfa.flash_fwd_cuda, pfa.flash_bwd_fused_cuda,
               pfa.flash_bwd_dq_cuda, pfa.flash_bwd_dkv_cuda):
        assert fn.wgmma_launches >= 0
        assert fn.wgmma_launches <= fn.tensor_core_launches <= fn.launches


# ---------------------------------------------------------------------------
# head dims the kernels do not take natively: zero-padded to 32, 64, 128
# or 256, and above 256 to a multiple of 128 (the wide route)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["forward", "fused", "split"])
@pytest.mark.parametrize("d", [16, 32, 80, 96, 200, 256, 320, 512])
def test_head_padding_is_exact_against_jax_kernels(d, kernel):
    """The CUDA wrappers' head-pad transform (``_pad_heads`` to
    ``_kernel_head_dim``, the kernel, ``_unpad_heads``) run around the
    plain versions, against the interpret-mode Pallas kernels on the
    unpadded inputs, at the same tolerances as above (forward 1e-4,
    backward 1e-3): zero columns change no score, and the scale stays that
    of the true head dim.  The backward gets the padded forward's own out
    and lse, padded again, as ``_Flash`` hands them on.  320 is padded to
    384 and 512 kept, in 128-column slices of the wide route."""
    b, s, h = 2, 96, 2
    q, k, v, do = _inputs(b, s, s, h, d, seed=5)
    segs = _segments("tuple", b, s, s)
    scale = 1.0 / np.sqrt(d)
    width = pfa._kernel_head_dim(d)
    assert width == {16: 32, 32: 32, 80: 128, 96: 128, 200: 256, 256: 256,
                     320: 384, 512: 512}[d]
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jl = jfa._flash_fwd(jq, jk, jv, scale, True, _to_jax(segs), 0)
    tq, tk, tv, tdo = pfa._pad_heads(width,
                                     *map(torch.from_numpy, (q, k, v, do)))
    assert tq.shape[-1] == width
    out, lse = pfa.flash_fwd_reference(tq, tk, tv, scale, True,
                                       _to_torch(segs))
    (po,) = pfa._unpad_heads(d, out)
    if kernel == "forward":
        assert po.shape == q.shape and po.is_contiguous()
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        return
    bwd = jfa._flash_bwd_fused if kernel == "fused" else jfa._flash_bwd_split
    want = bwd(scale, True, _to_jax(segs), (jq, jk, jv, jo, jl), jdo, 0)
    (po_padded,) = pfa._pad_heads(width, po)
    got = pfa._unpad_heads(d, *pfa.flash_bwd_reference(
        tq, tk, tv, po_padded, lse, tdo, scale, True, _to_torch(segs)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == q.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-3, err_msg=name)


# ---------------------------------------------------------------------------
# 3xTF32: the arithmetic of the fp32 and mixed tensor-core kernels
# ---------------------------------------------------------------------------

# the card gates (chip_smoke.py, phase 6): |got - want| <= tol (1 + |want|)
FP32_FWD_TOL = 1e-4
FP32_BWD_TOL = 1e-3


def _tf32(x):
    """x rounded to TF32 as the tensor cores' cvt.rna.tf32.f32 does: to
    nearest on 10 mantissa bits, ties away from zero (add half of the 13
    dropped bits to the magnitude, then clear them)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm_tf32(a, b, terms, b_exact=False):
    """a @ b from TF32 parts: three terms (lo.hi + hi.lo + hi.hi), or one
    (hi.hi); ``b_exact`` (a bf16 operand, exact in TF32): lo.b + hi.b."""
    ah, al = _split(a)
    if b_exact:
        return ah @ b if terms == 1 else al @ b + ah @ b
    bh, bl = _split(b)
    return ah @ bh if terms == 1 else al @ bh + ah @ bl + ah @ bh


def _tf32_kernels(q, k, v, do, scale, causal, segs, lse_in, out_in, terms):
    """The tensor-core kernels' arithmetic for fp32 q/k: the forward
    ``(out, lse)`` and, from the given ``(out_in, lse_in)``, the backward
    ``{"dq", "dq_fused", "dk", "dv"}``.  q * scale * log2(e) stays fp32;
    S = Q K^T (S^T = K Q^T has the same terms), dQ = dS K, dV = P^T dO and
    dK = dS^T Q in TF32 parts; P.V in TF32 parts for fp32 v, on P rounded
    to bf16 for bf16 v (the reference's :249); dO V^T (dP^T = V dO^T) in
    TF32 parts (two for bf16 v); P^T and dS in fp32.  The split kernels
    take delta from an fp32 sum, the fused kernel from an fp64 one."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    split_segs = pfa._split_segments(segs, sq, sk)
    bf16_v = v.dtype == torch.bfloat16
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq))
    grads = {"dq": torch.empty_like(q), "dq_fused": torch.empty_like(q),
             "dk": torch.empty_like(k), "dv": torch.empty_like(k)}
    for bi in range(b):
        mask = pfa._visible(bi, sq, sk, causal, 0, split_segs, "cpu")
        qs = (q[bi] * (scale * pfa.LOG2E)).transpose(0, 1)    # [h, sq, d]
        kf = k[bi].transpose(0, 1)
        vf = v[bi].float().transpose(0, 1)
        dof = do[bi].transpose(0, 1)
        s = _mm_tf32(qs, kf.transpose(1, 2), terms)           # base 2
        if mask is not None:
            s = s.masked_fill(~mask, float("-inf"))
        m = s.amax(-1, keepdim=True)
        live = torch.isfinite(m)
        p = torch.exp2(s - torch.where(live, m, 0.0))
        l = torch.where(live, p.sum(-1, keepdim=True), 1.0)
        pv = p.bfloat16().float() @ vf if bf16_v else _mm_tf32(p, vf, terms)
        out[bi] = torch.where(live, pv / l, 0.0).transpose(0, 1)
        lse[bi] = torch.where(live, (m + torch.log2(l)) / pfa.LOG2E,
                              float("-inf"))[..., 0]
        # dq from the given forward residuals
        l2 = lse_in[bi][..., None] * pfa.LOG2E
        keep = torch.isfinite(l2) if mask is None else \
            torch.isfinite(l2) & mask
        p = torch.where(keep, torch.exp2(s - torch.where(keep, l2, 0.0)), 0.0)
        dp = _mm_tf32(dof, vf.transpose(1, 2), terms, b_exact=bf16_v)
        of = out_in[bi].transpose(0, 1)
        for name, delta in (
                ("dq", (dof * of).sum(-1, keepdim=True)),
                ("dq_fused", (dof.double() * of.double()).sum(
                    -1, keepdim=True).float())):
            ds = p * (dp - delta)
            grads[name][bi] = (_mm_tf32(ds, kf, terms) * scale) \
                .transpose(0, 1)
        # dK = dS^T (Q scale log2(e)) / log2(e), dS from the fused delta
        grads["dv"][bi] = _mm_tf32(p.transpose(1, 2), dof, terms) \
            .transpose(0, 1)
        grads["dk"][bi] = (_mm_tf32(ds.transpose(1, 2), qs, terms)
                           / pfa.LOG2E).transpose(0, 1)
    return out, lse, grads


def _fp32_ratio(got, want, tol):
    return float(((got - want).abs() / (tol * (1 + want.abs()))).max())


# (name, d, v dtype, segments), causal, b 1, s 200, h 2
TF32_CASES = [
    ("fp32_d64", 64, torch.float32, None),
    ("fp32_d128", 128, torch.float32, None),
    ("mixed_d128_segments_tuple", 128, torch.bfloat16, "tuple"),
    ("mixed_d64", 64, torch.bfloat16, None),
]


@pytest.mark.parametrize("terms", [3, 1], ids=["3xtf32", "1xtf32"])
@pytest.mark.parametrize("case", TF32_CASES, ids=[c[0] for c in TF32_CASES])
def test_3xtf32_meets_the_fp32_gates_and_1xtf32_does_not(case, terms):
    """fp32 q/k (v fp32 or bf16) from numpy seeds: the 3xTF32 arithmetic of
    the card's kernels (forward, split dq, split dk/dv and the fused
    backward's dq part) against the plain fp32 versions at the card's fp32
    gates (out and dv at the bf16 limit for bf16 v: P.V rounds p to bf16
    as the reference does, and dv is stored in v's bf16), within them;
    one-term TF32 on the same inputs is over the forward's gate, so that
    gate tells the two apart.  This covers the rounding of the operands
    only: the TF32 parts are summed here by fp32 CPU products, not by the
    tensor cores' accumulator, whose bit loss over long chains (what
    ``kTf32Chain`` bounds) shows only on the card, in the smoke's kernel
    and training checks."""
    _, d, v_dtype, seg_kind = case
    b, s, h = 1, 200, 2
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(b, s, s, h, d,
                                                          seed=4))
    v = v.to(v_dtype)
    segs = _to_torch(_segments(seg_kind, b, 200, 200))
    scale = d ** -0.5
    ro, rl = pfa.flash_fwd_reference(q, k, v, scale, True, segs)
    rdq, rdk, rdv = pfa.flash_bwd_reference(q, k, v, ro, rl, do, scale, True,
                                            segs)
    out, lse, got = _tf32_kernels(q, k, v, do, scale, True, segs, rl, ro,
                                  terms)
    live = torch.isfinite(rl)
    assert torch.equal(torch.isinf(lse), torch.isinf(rl))
    fwd = [_fp32_ratio(lse[live], rl[live], FP32_FWD_TOL)]
    if v_dtype == torch.float32:
        fwd.append(_fp32_ratio(out, ro, FP32_FWD_TOL))
        dv = _fp32_ratio(got["dv"], rdv, FP32_BWD_TOL)
    else:
        fwd.append(_bf16_limit_ratio(out, ro.numpy(), (3,)))
        dv = _bf16_limit_ratio(got["dv"].to(v_dtype).float(),
                               rdv.float().numpy(), (3,))
    bwd = {"dq": _fp32_ratio(got["dq"], rdq, FP32_BWD_TOL),
           "dq_fused": _fp32_ratio(got["dq_fused"], rdq, FP32_BWD_TOL),
           "dk": _fp32_ratio(got["dk"], rdk, FP32_BWD_TOL), "dv": dv}
    if terms == 3:
        assert max(fwd) <= 1.0 and max(bwd.values()) <= 1.0, (fwd, bwd)
    else:
        # the backward gate alone does not tell them apart: one-term dk
        # reads 1.00-1.54 of it here, dq 0.70-1.07 and dv 0.37-1.06
        # (``csrc/planted_faults.py``'s ``tf32_1term_dkv`` checks the card)
        assert max(fwd) > 1.0, (fwd, bwd)
