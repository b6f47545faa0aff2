"""Card-only tests of the port's CUDA kernels against their plain versions
(ragged paged attention; flash attention forward, fused backward and
split dq / dk-dv backward; latent ragged paged attention; paged decode
attention).

Marked ``cuda``; they skip where no CUDA device is present (the check
runs inside the fixture, never at import).  The file imports neither
JAX nor the JAX package, so on a machine without JAX it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernel.py
"""
import numpy as np
import pytest
import torch

from hetu_tpu_torch.ops.ragged_paged_attention import (
    ragged_paged_attention, ragged_paged_attention_cuda,
    ragged_paged_attention_reference)

pytestmark = pytest.mark.cuda

# (q_lens, ctx_lens, maxp, ps, nh, kvh, hd, max_q)
CASES = [
    ([1, 5, 0, 6], [13, 10, 0, 6], 3, 8, 4, 2, 64, 8),
    ([1, 1, 1, 1], [9, 3, 17, 1], 3, 8, 4, 2, 128, 8),
    ([8, 8], [8, 24], 4, 8, 4, 4, 64, 8),
    ([3, 0, 0, 7], [20, 0, 0, 7], 4, 8, 8, 2, 128, 8),
    ([1, 1, 0, 37], [300, 64, 0, 200], 5, 64, 32, 8, 128, 64),
    ([40, 1, 3], [40, 130, 3], 3, 64, 12, 4, 64, 40),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(case, dtype, device, seed=0):
    q_lens, ctx_lens, maxp, ps, nh, kvh, hd, max_q = case
    rng = np.random.RandomState(seed)
    s = len(q_lens)
    cu = np.zeros(s + 1, np.int32)
    cu[1:] = np.cumsum(q_lens)
    t = max(int(cu[-1]), 1) + 3                  # trailing padding tokens
    num_pages = 1 + sum(-(-c // ps) for c in ctx_lens) + 2
    perm = rng.permutation(np.arange(1, num_pages))
    pt = np.zeros((s, maxp), np.int32)           # padding slots -> page 0
    k = 0
    for i in range(s):
        need = -(-ctx_lens[i] // ps)
        pt[i, :need] = perm[k:k + need]
        k += need

    def dev(a, dt=None):
        x = torch.from_numpy(np.ascontiguousarray(a))
        return x.to(device=device, dtype=dt) if dt else x.to(device)

    args = (dev(rng.randn(t, nh, hd), dtype),
            dev(rng.randn(num_pages, ps, kvh, hd), dtype),
            dev(rng.randn(num_pages, ps, kvh, hd), dtype),
            dev(np.asarray(q_lens, np.int32)), dev(cu), dev(pt),
            dev(np.asarray(ctx_lens, np.int32)))
    mask = np.zeros(t, bool)
    for i in range(s):
        mask[cu[i]:cu[i] + min(q_lens[i], max_q)] = True
    return args, max_q, torch.from_numpy(mask)


def _limit(want, args, max_q, dtype):
    """fp32: 2e-5 (sum order only).  bf16, within each row: one output
    ulp (2**-7 of the value) plus 1/32 of the row's output RMS for the
    probabilities the kernel rounds to bf16 (both sides accumulate in
    fp32); the limit shrinks with the outputs of long rows."""
    if dtype == torch.float32:
        return torch.full_like(want, 2e-5, dtype=torch.float32)
    limit = torch.zeros_like(want, dtype=torch.float32)
    q_lens, cu = args[3].tolist(), args[4].tolist()
    for i, n in enumerate(q_lens):
        w = want[cu[i]:cu[i] + min(n, max_q)].float()
        if w.numel():
            limit[cu[i]:cu[i] + w.shape[0]] = (
                2.0 ** -7 * w.abs() + w.pow(2).mean().sqrt() / 32)
    return limit


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_version(cuda_device, case, dtype):
    args, max_q, mask = _inputs(case, dtype, cuda_device)
    before = ragged_paged_attention_cuda.launches
    got = ragged_paged_attention(*args, max_q=max_q)
    torch.cuda.synchronize()
    assert ragged_paged_attention_cuda.launches == before + 1
    want = ragged_paged_attention_reference(*args, max_q=max_q)
    mask = mask.to(cuda_device)
    over = ((got.float() - want.float()).abs()
            - _limit(want, args, max_q, dtype))[mask]
    assert over.max().item() <= 0, over.max().item()
    assert torch.count_nonzero(got[~mask]).item() == 0


def test_kernel_rejects_mixed_dtypes(cuda_device):
    args, max_q, _ = _inputs(CASES[0], torch.float32, cuda_device)
    bad = (args[0].bfloat16(),) + args[1:]
    with pytest.raises(ValueError, match="share a dtype"):
        ragged_paged_attention_cuda(*bad, max_q=max_q)


def test_kernel_rejects_misaligned_pages(cuda_device):
    """A contiguous view 8 bytes into its storage is refused before the
    launch, not left to fault at a later sync."""
    args, max_q, _ = _inputs(CASES[1], torch.bfloat16, cuda_device)
    k = args[1]
    shifted = torch.empty(k.numel() + 4, dtype=k.dtype,
                          device=cuda_device)[4:].view(k.shape)
    shifted.copy_(k)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 8
    bad = args[:1] + (shifted,) + args[2:]
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        ragged_paged_attention_cuda(*bad, max_q=max_q)


# ---------------------------------------------------------------------------
# flash attention kernels 1-4 (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

from hetu_tpu_torch.ops import flash_attention as fa  # noqa: E402

F32, B16 = torch.float32, torch.bfloat16
FLASH_DTYPES = {"fp32": (F32, F32), "bf16": (B16, B16),
                "fp32_qk_bf16_v": (F32, B16)}
# (b, sq, sk, h, d, causal, segments, causal_offset)
FLASH_CASES = [
    (2, 128, 128, 2, 64, True, None, 0),
    (1, 200, 200, 3, 128, True, None, 0),        # ragged edge tile
    (2, 96, 96, 2, 64, False, None, 0),
    (2, 128, 128, 2, 128, True, "array", 0),
    (1, 64, 192, 2, 64, True, "tuple", 128),     # sq != sk, offset
    (2, 128, 128, 2, 64, True, "masked", 0),     # fully-masked rows
    (1, 1000, 1000, 2, 128, True, None, 0),      # irregular length
    # across the 64-row tiles and 16-row warp slices of the bf16 kernels
    (1, 65, 65, 2, 64, True, None, 0),           # one row past a tile
    (1, 127, 127, 2, 128, True, None, 0),        # one row short of two
    (1, 100, 300, 2, 128, True, None, 200),      # sq != sk, causal offset
    (1, 200, 136, 2, 128, True, None, -40),      # rows that see no key
    (5, 128, 128, 16, 64, True, None, 0),        # b * h = 80 blocks a tile
    (2, 130, 130, 3, 64, False, None, 0),        # h = 3: token stride 192
]


def _flash_inputs(case, dtypes, device, seed=0):
    b, sq, sk, h, d, causal, seg, offset = case
    qk, vt = FLASH_DTYPES[dtypes]
    rng = np.random.RandomState(seed)

    def t(shape, dt):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)) \
            .to(device=device, dtype=dt)

    q, k, v = t((b, sq, h, d), qk), t((b, sk, h, d), qk), t((b, sk, h, d), vt)
    do = t((b, sq, h, d), qk)
    segs = None
    if seg == "array":
        segs = torch.from_numpy(np.repeat(np.arange(4), sq // 4)[None]
                                .repeat(b, 0).astype(np.int32)).to(device)
    elif seg in ("tuple", "masked"):
        kv = np.repeat(np.arange(2), sk // 2)[None].repeat(b, 0) \
            .astype(np.int32)
        qi = kv[:, sk - sq:].copy()
        if seg == "masked":
            qi[:, sq // 2:] = 7
        segs = (torch.from_numpy(qi).to(device), torch.from_numpy(kv).to(device))
    return q, k, v, do, segs, causal, offset, d ** -0.5


def _assert_close(got, want, reduce_dims, bf16, fp32_tol, what):
    """fp32: |got - want| <= tol (1 + |want|).  With a bf16 operand: within
    each row (a query's out/dq, a key's dk/dv), one bf16 ulp of the value
    plus 1/32 of the row's RMS, for the products that the kernel rounds to
    bf16 (both sides accumulate in fp32), plus 2**-16 of
    the whole tensor's RMS for rows that cancel to rounding noise (the
    first causal row's dq: p = 1 and dp = delta, so ds = 0 up to the
    order of two fp32 sums)."""
    g, w = got.float(), want.float()
    if bf16:
        rms = w.pow(2).mean(dim=reduce_dims, keepdim=True).sqrt()
        limit = 2.0 ** -7 * w.abs() + rms / 32 + \
            2.0 ** -16 * w.pow(2).mean().sqrt()
    else:
        limit = fp32_tol * (1 + w.abs())
    over = ((g - w).abs() - limit).max().item()
    assert over <= 0, f"{what}: over the limit by {over}"


@pytest.mark.parametrize("dtypes", sorted(FLASH_DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_match_plain_versions(cuda_device, case, dtypes):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do, segs, causal, off, scale = _flash_inputs(case, dtypes,
                                                          cuda_device)
    bf16 = dtypes != "fp32"
    wrappers = (fa.flash_fwd_cuda, fa.flash_bwd_fused_cuda,
                fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda)
    n0 = [(w.launches, w.tensor_core_launches) for w in wrappers]
    out, lse = fa.flash_fwd_cuda(q, k, v, scale, causal, segs, off)
    torch.cuda.synchronize()
    assert fa.flash_fwd_cuda.launches == n0[0][0] + 1
    ro, rl = fa.flash_fwd_reference(q, k, v, scale, causal, segs, off)
    assert out.dtype == q.dtype and lse.dtype == F32
    _assert_close(out, ro, (3,), bf16, 1e-4, "out")
    assert torch.equal(torch.isinf(lse), torch.isinf(rl))
    live = torch.isfinite(rl)
    rl_q = rl
    if dtypes == "bf16":
        # the bf16 kernel rounds q * scale * log2(e) to bf16 as the
        # reference does (flash_attention.py:274); its lse is the plain
        # version's on that rounded operand
        rl_q = fa.flash_fwd_reference(
            (q.float() * (scale * fa.LOG2E)).to(q.dtype), k, v, 1 / fa.LOG2E,
            causal, segs, off)[1]
    _assert_close(lse[live], rl_q[live], (0,), False, 1e-4, "lse")
    if case[6] == "masked":
        assert torch.count_nonzero(out[:, case[1] // 2:]).item() == 0

    # the backward kernels from the same residuals (the plain forward's)
    want = fa.flash_bwd_reference(q, k, v, ro, rl, do, scale, causal, segs,
                                  off)
    fused = fa.flash_bwd_fused_cuda(q, k, v, ro, rl, do, scale, causal, segs,
                                    off)
    delta = torch.einsum("bshd,bshd->bsh", do.float(), ro.float())
    split = (fa.flash_bwd_dq_cuda(q, k, v, do, rl, delta, scale, causal,
                                  segs, off),
             *fa.flash_bwd_dkv_cuda(q, k, v, do, rl, delta, scale, causal,
                                    segs, off))
    torch.cuda.synchronize()
    for kind, got in (("fused", fused), ("split", split)):
        for name, g, w, dims in zip(("dq", "dk", "dv"), got, want,
                                    ((3,), (3,), (3,))):
            assert g.dtype == w.dtype, (kind, name)
            _assert_close(g, w, dims, bf16, 1e-3, f"{kind} {name}")
        if case[6] == "masked":
            assert torch.count_nonzero(got[0][:, case[1] // 2:]).item() == 0
        if case[7] < 0:
            # queries that see no key: zero gradients
            rows = slice(0, -case[7])
            assert torch.count_nonzero(got[0][:, rows]).item() == 0
    if case[7] < 0:
        assert torch.count_nonzero(out[:, :-case[7]]).item() == 0
        assert bool((lse[:, :, :-case[7]] == float("-inf")).all())
    # bf16 q/k/v launch the tensor-core forward and dk/dv kernels (the
    # fused backward is the dk/dv template); dq, and every kernel of the
    # other type mixes, the scalar ones
    mma = dtypes == "bf16"
    assert [(w.launches - a, w.tensor_core_launches - t)
            for w, (a, t) in zip(wrappers, n0)] == \
        [(1, int(mma)), (1, int(mma)), (1, 0), (1, int(mma))]


def test_flash_dispatch_takes_the_byte_rule_on_cuda(cuda_device):
    q, k, v, do, *_ = _flash_inputs(FLASH_CASES[0], "bf16", cuda_device)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    counts = (fa.flash_bwd_fused_cuda.launches, fa.flash_bwd_dq_cuda.launches)
    out = fa.flash_attention(q, k, v, causal=True)
    torch.autograd.grad(out, (q, k, v), do)
    assert fa.flash_bwd_fused_cuda.launches == counts[0] + 1   # sk*d small
    assert fa.flash_bwd_dq_cuda.launches == counts[1]


def test_flash_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q, k, v, do, *_ = _flash_inputs(FLASH_CASES[0], "fp32", cuda_device)
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_fwd_cuda(q.half(), k.half(), v.half(), 0.1, True)
    with pytest.raises(ValueError, match="head_dim 32"):
        fa.flash_fwd_cuda(q[..., :32].contiguous(), k[..., :32].contiguous(),
                          v[..., :32].contiguous(), 0.1, True)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd_cuda(q.transpose(1, 2).contiguous().transpose(1, 2),
                          k, v, 0.1, True)
    shifted = torch.empty(q.numel() + 2, dtype=q.dtype,
                          device=cuda_device)[2:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        fa.flash_fwd_cuda(shifted, k, v, 0.1, True)
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.flash_fwd_cuda(q.cpu(), k, v, 0.1, True)


# ---------------------------------------------------------------------------
# latent ragged paged attention, kernel 6 (csrc/latent_ragged_paged_attention.cu)
# ---------------------------------------------------------------------------

from hetu_tpu_torch.ops import ragged_paged_attention as rpa  # noqa: E402
from hetu_tpu_torch.ops.quantization import quantize_rows  # noqa: E402

# (q_lens, ctx_lens, maxp, ps, nh, d_c, d_r, max_q)
LATENT_CASES = [
    ([1, 5, 0, 6], [13, 10, 0, 6], 3, 8, 4, 16, 4, 8),
    ([1, 5, 0, 6], [13, 10, 0, 6], 3, 8, 4, 16, 0, 8),
    ([1, 1, 1, 1], [9, 3, 17, 1], 3, 8, 5, 16, 4, 8),     # one-token context
    ([8, 8], [8, 24], 4, 8, 5, 16, 0, 8),                 # nh 5: ragged tiles
    ([3, 0, 0, 7], [20, 0, 0, 7], 4, 8, 12, 256, 0, 8),
    ([1, 1, 0, 37], [300, 64, 0, 200], 5, 64, 32, 512, 64, 64),
    ([40, 1, 3], [40, 130, 3], 3, 64, 12, 128, 32, 40),
    # short rows split over the KV axis, one slice wholly masked for the
    # first tokens of the 4-token row
    ([1, 2, 4, 1], [500, 130, 257, 1], 8, 64, 12, 256, 0, 8),
]
# page kinds: (quant, page dtype)
LATENT_KINDS = {"fp32": (None, torch.float32), "bf16": (None, torch.bfloat16),
                "int8": ("int8", None), "nf4": ("nf4", None)}


def _latent_inputs(case, kind, device, seed=0):
    q_lens, ctx_lens, maxp, ps, nh, d_c, d_r, max_q = case
    quant, page_dtype = LATENT_KINDS[kind]
    rng = np.random.RandomState(seed)
    s = len(q_lens)
    cu = np.zeros(s + 1, np.int32)
    cu[1:] = np.cumsum(q_lens)
    t = max(int(cu[-1]), 1) + 3                  # trailing padding tokens
    num_pages = 1 + sum(-(-c // ps) for c in ctx_lens) + 2
    perm = rng.permutation(np.arange(1, num_pages))
    pt = np.zeros((s, maxp), np.int32)           # padding slots -> page 0
    k = 0
    for i in range(s):
        need = -(-ctx_lens[i] // ps)
        pt[i, :need] = perm[k:k + need]
        k += need

    def dev(a, dt=None):
        x = torch.from_numpy(np.ascontiguousarray(a))
        return x.to(device=device, dtype=dt) if dt else x.to(device)

    q = dev(rng.randn(t, nh, d_c + d_r).astype(np.float32))
    lat = dev(rng.randn(num_pages, ps, 1, d_c).astype(np.float32))
    lat[3, 1] = 0                                # a zero row: absmax 0
    r_pages = scale_pages = None
    if quant:
        c_pages, scale_pages = quantize_rows(lat, quant)
    else:
        c_pages = lat.to(page_dtype)
        if d_r:
            r_pages = dev(rng.randn(num_pages, ps, 1, d_r), page_dtype)
    args = (q, c_pages, r_pages, dev(np.asarray(q_lens, np.int32)), dev(cu),
            dev(pt), dev(np.asarray(ctx_lens, np.int32)))
    kw = dict(max_q=max_q, softmax_scale=(d_c // 4 + d_r) ** -0.5,
              scale_pages=scale_pages, quant=quant, latent_dim=d_c)
    mask = np.zeros(t, bool)
    for i in range(s):
        mask[cu[i]:cu[i] + min(q_lens[i], max_q)] = True
    return args, kw, torch.from_numpy(mask).to(device)


@pytest.mark.parametrize("kind", sorted(LATENT_KINDS))
@pytest.mark.parametrize("case", LATENT_CASES)
def test_latent_kernel_matches_plain_version(cuda_device, case, kind):
    """fp32 products on both sides against the same dequantized values:
    |got - want| <= 1e-4 (1 + |want|), the order of fp32 sums."""
    if LATENT_KINDS[kind][0] and case[6]:
        pytest.skip("quantized latent pages carry no rope stream")
    torch.backends.cuda.matmul.allow_tf32 = False
    args, kw, mask = _latent_inputs(case, kind, cuda_device)
    before = rpa.latent_ragged_paged_attention_cuda.launches
    got = rpa.latent_ragged_paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert rpa.latent_ragged_paged_attention_cuda.launches == before + 1
    want = rpa.latent_ragged_paged_attention_reference(*args, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    over = ((got - want).abs() - 1e-4 * (1 + want.abs()))[mask]
    assert over.max().item() <= 0, over.max().item()
    assert torch.count_nonzero(got[~mask]).item() == 0


def test_latent_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    args, kw, _ = _latent_inputs(LATENT_CASES[0], "fp32", cuda_device)
    q, c_pages, r_pages = args[:3]
    with pytest.raises(ValueError, match="must be float32"):
        rpa.latent_ragged_paged_attention_cuda(q.bfloat16(), *args[1:], **kw)
    with pytest.raises(ValueError, match="r_pages torch.bfloat16"):
        rpa.latent_ragged_paged_attention_cuda(
            q, c_pages, r_pages.bfloat16(), *args[3:], **kw)
    with pytest.raises(ValueError, match="no latent kernel"):
        rpa.latent_ragged_paged_attention_cuda(
            q, c_pages.half(), r_pages.half(), *args[3:], **kw)
    # a width the kernel does not cover raises instead of falling back
    wide = torch.zeros(4, 8, 1, 516, device=cuda_device)
    with pytest.raises(ValueError, match="not covered by the kernel"):
        rpa.latent_ragged_paged_attention(
            torch.zeros(q.shape[0], 4, 516, device=cuda_device), wide, None,
            *args[3:], **{**kw, "latent_dim": 516})
    odd = torch.zeros(4, 8, 1, 18, device=cuda_device)
    with pytest.raises(ValueError, match="not covered by the kernel"):
        rpa.latent_ragged_paged_attention(
            torch.zeros(q.shape[0], 4, 18, device=cuda_device), odd, None,
            *args[3:], **{**kw, "latent_dim": 18})
    with pytest.raises(ValueError, match="one CUDA device"):
        rpa.latent_ragged_paged_attention_cuda(q, c_pages.cpu(), *args[2:],
                                               **kw)
    with pytest.raises(ValueError, match="need scale_pages"):
        rpa.latent_ragged_paged_attention_cuda(
            q[..., :16].contiguous(), c_pages.to(torch.int8), None,
            *args[3:], **{**kw, "quant": "int8"})


# ---------------------------------------------------------------------------
# paged decode attention, kernel 7 (csrc/paged_attention.cu)
# ---------------------------------------------------------------------------

from hetu_tpu_torch.ops import paged_attention as pa  # noqa: E402

# (seq_lens, maxp, ps, nh, kvh, hd)
PAGED_CASES = [
    ([13, 5, 24], 3, 8, 8, 2, 32),
    ([19, 8], 4, 8, 4, 2, 64),
    ([9, 17, 0, 1], 3, 8, 4, 4, 128),            # MHA, seq_len 0 and 1
    ([1, 8, 2], 2, 4, 10, 2, 64),                # g = 5: two head chunks
    ([300, 64, 0, 1000, 513], 16, 64, 32, 8, 128),     # split KV axis
    ([70, 129], 3, 64, 24, 2, 64),               # g = 12: three head chunks
]


def _paged_inputs(case, dtype, device, seed=0):
    seq_lens, maxp, ps, nh, kvh, hd = case
    rng = np.random.RandomState(seed)
    b = len(seq_lens)
    num_pages = 1 + sum(-(-c // ps) for c in seq_lens) + 2
    perm = rng.permutation(np.arange(1, num_pages))
    pt = np.zeros((b, maxp), np.int32)           # padding slots -> page 0
    k = 0
    for i in range(b):
        need = -(-seq_lens[i] // ps)
        pt[i, :need] = perm[k:k + need]
        k += need

    def dev(a, dt=None):
        x = torch.from_numpy(np.ascontiguousarray(a))
        return x.to(device=device, dtype=dt) if dt else x.to(device)

    return (dev(rng.randn(b, nh, hd), dtype),
            dev(rng.randn(num_pages, ps, kvh, hd), dtype),
            dev(rng.randn(num_pages, ps, kvh, hd), dtype), dev(pt),
            dev(np.asarray(seq_lens, np.int32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_kernel_matches_plain_version(cuda_device, case, dtype):
    """fp32: 2e-5 (sum order only).  bf16: both sides accumulate in fp32
    and round the output once, so within each request one bf16 ulp of the
    value (2**-7) plus 1/32 of the request's output RMS.  A request with
    seq_len == 0 gives a zero row (the plain version gives NaN there)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _paged_inputs(case, dtype, cuda_device)
    before = pa.paged_attention_cuda.launches
    got = pa.paged_attention_decode(*args)
    torch.cuda.synchronize()
    assert pa.paged_attention_cuda.launches == before + 1
    assert got.dtype == dtype
    want = pa.paged_attention_reference(*args)
    live = args[4] > 0
    assert torch.count_nonzero(got[~live]).item() == 0
    g, w = got[live].float(), want[live].float()
    if dtype == torch.float32:
        limit = torch.full_like(w, 2e-5)
    else:
        limit = 2.0 ** -7 * w.abs() + \
            w.pow(2).mean(dim=(1, 2), keepdim=True).sqrt() / 32
    over = ((g - w).abs() - limit).max().item()
    assert over <= 0, over


def test_paged_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    q, kp, vp, pt, sl = _paged_inputs(PAGED_CASES[0], torch.float32,
                                      cuda_device)
    with pytest.raises(ValueError, match="share a dtype"):
        pa.paged_attention_cuda(q.bfloat16(), kp, vp, pt, sl)
    with pytest.raises(ValueError, match="head_dim 16"):
        pa.paged_attention_decode(q[..., :16].contiguous(),
                                  kp[..., :16].contiguous(),
                                  vp[..., :16].contiguous(), pt, sl)
    with pytest.raises(ValueError, match="must be int32"):
        pa.paged_attention_cuda(q, kp, vp, pt.long(), sl)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention_cuda(q.transpose(0, 1).contiguous().transpose(0, 1),
                                kp, vp, pt, sl)
    with pytest.raises(ValueError, match="one CUDA device"):
        pa.paged_attention_cuda(q.cpu(), kp, vp, pt, sl)
