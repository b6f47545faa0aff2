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
    # head dim 32 (the LLaMA config of __graft_entry__: 8 heads of 32)
    ([1, 5, 0, 6], [13, 10, 0, 6], 3, 8, 4, 2, 32, 8),
    ([40, 1, 3], [40, 130, 3], 3, 64, 8, 8, 32, 40),
    # head dims read in place at a wider template width: 80 and 96 (at
    # 128), 256 (two column halves), 100 (rows not on 16-byte boundaries)
    # and 67 (odd: element loads)
    ([1, 5, 0, 6], [13, 10, 0, 6], 3, 8, 4, 2, 80, 8),
    ([40, 1, 3], [40, 130, 3], 3, 64, 8, 4, 96, 40),
    ([1, 1, 0, 37], [300, 64, 0, 200], 5, 64, 8, 2, 256, 64),
    ([3, 0, 0, 7], [20, 0, 0, 7], 4, 8, 8, 2, 100, 8),
    ([1, 5, 0, 6], [13, 10, 0, 6], 3, 8, 4, 2, 67, 8),
    # decode-heavy batches through the split-KV decode core: many slices
    # (capacity 4096: 16 slices of 256 on an H100), q_len 1 beside a chunk,
    # contexts on slice edges (256, 257) and page edges (64, 65, 320 inside
    # the second slice), one slice (a pool of 16 positions)
    ([1, 1, 1, 1, 0, 1, 40], [4096, 256, 257, 65, 0, 320, 300], 64, 64, 32,
     8, 128, 64),
    ([1, 1, 1, 1, 1, 1], [4096, 3001, 1500, 64, 1, 2048], 64, 64, 32, 8, 128,
     1),
    ([1, 1], [13, 5], 2, 8, 8, 2, 64, 8),
    # head dims above 256 (every token through the decode core), and 300
    # (rows on 8-byte, not 16-byte, boundaries in bf16)
    ([1, 5, 0, 6], [13, 10, 0, 6], 3, 8, 4, 2, 264, 8),
    ([1, 1, 0, 37], [300, 64, 0, 200], 5, 64, 8, 2, 320, 64),
    ([40, 1, 3], [40, 130, 3], 3, 64, 8, 4, 512, 40),
    ([1, 1, 0, 37], [300, 64, 0, 200], 5, 64, 8, 2, 300, 64),
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


def test_kernel_refuses_head_dims_above_256(cuda_device):
    """Head dims above 256 are no longer refused (fault F1 closed): 264
    runs through the decode core and agrees with the plain version."""
    case = CASES[0][:6] + (264, CASES[0][7])
    args, max_q, mask = _inputs(case, torch.float32, cuda_device)
    got = ragged_paged_attention_cuda(*args, max_q=max_q)
    torch.cuda.synchronize()
    want = ragged_paged_attention_reference(*args, max_q=max_q)
    assert got.shape[-1] == 264
    mask = mask.to(cuda_device)
    assert (got - want).abs()[mask].max().item() <= 2e-5


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
    # head dim 32 natively, and 96 zero-padded to 128 by the wrappers
    (2, 128, 128, 4, 32, True, "array", 0),
    (1, 200, 136, 2, 32, True, None, -40),
    (2, 130, 130, 3, 32, False, None, 0),
    (1, 200, 200, 2, 96, True, None, 0),
    (1, 64, 192, 2, 96, True, "tuple", 128),
    # head dim 256 natively (two column halves), 200 zero-padded to 256
    (1, 200, 200, 2, 256, True, None, 0),
    (2, 128, 128, 2, 256, True, "array", 0),
    (1, 200, 136, 2, 256, True, None, -40),
    (2, 130, 130, 3, 256, False, None, 0),
    (1, 200, 200, 2, 200, True, None, 0),
    (1, 64, 192, 2, 200, True, "tuple", 128),
    # the wide route: 512 and 320 (padded to 384), 264 and 300 (padded to
    # 384, 300 off the 8-element boundary)
    (1, 200, 200, 2, 512, True, None, 0),
    (2, 128, 128, 2, 512, True, "masked", 0),
    (1, 200, 136, 2, 320, True, None, -40),
    (1, 64, 192, 2, 320, True, "tuple", 128),
    (2, 130, 130, 3, 264, False, None, 0),
    (1, 100, 300, 2, 300, True, None, 200),
    # bf16 on wgmma at head dims 64 and 128 (the other types on 3xTF32):
    # sq and sk off the 128-row tiles, sq != sk with a causal offset,
    # segment tuples with rows that see no key, rows before a negative
    # offset that see none
    (1, 300, 200, 2, 64, True, None, -150),
    (2, 200, 328, 2, 128, True, "tuple", 128),
    (1, 192, 320, 3, 64, True, "masked", 128),
    (2, 72, 200, 2, 128, True, "masked", 128),
    (1, 129, 257, 2, 128, False, None, 0),
    (3, 257, 130, 2, 64, True, None, -3),
    # BERT-base's non-causal attention (s 512, 12 heads of 64), the batch
    # cut from 16 to 2
    (2, 512, 512, 12, 64, False, None, 0),
    # the ring's sym pairs on a block of 256 tokens: the tail half causal
    # against the whole block at offset 128, COL (the kv head half), ROW
    # (the q tail half, with a (q_ids, kv_ids) tuple)
    (1, 128, 256, 2, 128, True, None, 128),
    (1, 256, 128, 2, 128, False, None, 0),
    (1, 128, 256, 2, 128, False, "tuple", 0),
]
WIDE = 256     # above this head dim the wide route runs, on the CUDA cores
WGMMA_HEAD_DIMS = (64, 128)  # every bf16 flash kernel on wgmma


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
    n0 = [(w.launches, w.tensor_core_launches, w.tf32_launches,
           w.wgmma_launches) for w in wrappers]
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
    # up to head dim 256 every kernel launches on the tensor cores in every
    # type mix: for bf16 q/k/v the forward, dq and dk/dv (split and fused)
    # on wgmma at (padded) head dims 64 and 128, the other widths on bf16
    # mma.sync; 3xTF32 for fp32 q/k; above, on the wide route's CUDA
    # cores
    wide = case[4] > WIDE
    tc, tf32 = int(not wide), int(dtypes != "bf16" and not wide)
    wg = int(dtypes == "bf16" and
             fa._kernel_head_dim(case[4]) in WGMMA_HEAD_DIMS)
    assert [(w.launches - a, w.tensor_core_launches - t,
             w.tf32_launches - f, w.wgmma_launches - g)
            for w, (a, t, f, g) in zip(wrappers, n0)] == \
        [(1, tc, tf32, wg)] * 4


@pytest.mark.parametrize("dtypes", ["bf16", "fp32_qk_bf16_v"])
@pytest.mark.parametrize("pattern,kind", [
    ("normal", 0), ("normal", 1), ("normal", 2), ("sym", 0), ("sym", 1),
    ("sym", 2)])
def test_ring_pairs_on_the_card_match_the_plain_versions(cuda_device,
                                                         pattern, kind,
                                                         dtypes):
    """Each ring pair class (normal CAUSAL/FULL/EMPTY, sym CAUSAL_SYM/COL/
    ROW) with travelling ids (q padding -1, kv padding -2), through the
    kernels against the same pair on CPU tensors (the plain versions):
    the forward, and the backward of both from the plain forward's out
    and lse, so that each is checked on its own."""
    import importlib
    ra = importlib.import_module("hetu_tpu_torch.parallel.ring_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    case = (1, 256, 256, 2, 128, True, None, 0)
    q, k, v, do, _, _, _, scale = _flash_inputs(case, dtypes, "cpu", seed=5)
    q_ids = torch.from_numpy(np.repeat(np.arange(4), 64)[None]
                             .astype(np.int32))
    kv_ids = q_ids.clone()
    q_ids[:, 250:] = -1
    kv_ids[:, 240:] = -2
    res, plain = {}, None
    for dev in ("cpu", cuda_device):
        t = [x.to(dev) for x in (q, k, v, do)]
        segs = (q_ids.to(dev), kv_ids.to(dev))
        o, lse = ra._pair_fwd(*t[:3], scale, kind, segs, pattern, True)
        o = o.to(q.dtype)
        if plain is None:
            plain = (o, lse)
        grads = ra._pair_bwd(*t[:3], t[3], plain[0].to(dev),
                             plain[1].to(dev), scale, kind, segs, pattern,
                             True)
        torch.cuda.synchronize()
        res[dev] = [x.cpu() for x in (o, lse, *grads)]
    (o, lse, *g), (ro, rl, *rg) = res[cuda_device], res["cpu"]
    bf16_qk, bf16_v = dtypes == "bf16", True
    assert torch.equal(torch.isinf(lse), torch.isinf(rl))
    _assert_close(o, ro, (3,), bf16_v, 1e-4, "out")
    for name, a, b, bf in zip(("dq", "dk", "dv"), g, rg,
                              (bf16_qk, bf16_qk, True)):
        _assert_close(a, b, (3,), bf, 1e-3, name)


@pytest.mark.parametrize("d", [32, 64, 128, 256, 384])
def test_flash_route_codes_and_kernel_info(cuda_device, d):
    """The library reports route 3 (wgmma) for the bf16 forward, dq and
    dk/dv at head dims 64 and 128, bf16 mma.sync (1) for the other
    widths, 3xTF32 (2) for fp32 q/k, the wide route (0) above 256; the
    wgmma kernels take 384 threads' worth of shared memory for one block
    an SM."""
    lib = fa._kernel_lib()
    for code in (0, 1, 2):
        for entry in (fa._ENTRY_FWD, fa._ENTRY_DQ, fa._ENTRY_DKV):
            route = lib.hetu_flash_uses_tensor_cores(entry, d, code)
            if d > WIDE:
                want = 0
            elif code != 1:
                want = 2
            elif d in WGMMA_HEAD_DIMS:
                want = 3
            else:
                want = 1
            assert route == want, (entry, d, code)
    if d in WGMMA_HEAD_DIMS:
        for entry, fused in ((fa._ENTRY_FWD, False), (fa._ENTRY_DQ, False),
                             (fa._ENTRY_DKV, False), (fa._ENTRY_DKV, True)):
            smem, blocks = fa._kernel_info(entry, d, 1, fused)
            assert blocks == 1 and 64 * 1024 < smem <= 227 * 1024


# the split dq kernel's edges on wgmma (bf16, head dims 64 and 128): sq
# off the 128-row q tile with row 0 seeing one key; sq != sk with a causal
# offset and (q_ids, kv_ids) segments, where the first q row of the second
# segment sees one key; rows before a negative offset that see no key,
# then one that sees one; segment ids that no key has; packed documents,
# whose first rows see one key each
DQ_EDGE_CASES = [
    (1, 300, 300, 2, 128, True, None, 0),
    (2, 200, 328, 2, 64, True, "tuple", 128),
    (2, 200, 136, 2, 128, True, None, -40),
    (1, 192, 320, 3, 64, True, "masked", 128),
    (2, 256, 256, 2, 128, True, "array", 0),
]


def _single_key_dq(case, device, delta_dtype=torch.float32):
    """The bf16 split dq of ``case`` on wgmma (its delta rounded through
    ``delta_dtype`` first), the plain version's dq, and the rows that see
    one key and none.  On the rows that see one key, ``dq / bound`` of the
    kernel against an fp64 plain version, the bound being
    ``chip_smoke.single_key_ulps``: the largest ratio."""
    from chip_smoke import single_key_fp64, single_key_rows
    q, k, v, do, segs, causal, off, scale = _flash_inputs(case, "bf16",
                                                          device)
    b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    ro, rl = fa.flash_fwd_reference(q, k, v, scale, causal, segs, off)
    delta = torch.einsum("bshd,bshd->bsh", do.float(), ro.float())
    delta = delta.to(delta_dtype).float()
    n0 = fa.flash_bwd_dq_cuda.wgmma_launches
    got = fa.flash_bwd_dq_cuda(q, k, v, do, rl, delta, scale, causal, segs,
                               off)
    torch.cuda.synchronize()
    assert fa.flash_bwd_dq_cuda.wgmma_launches == n0 + 1
    want = fa.flash_bwd_reference(q, k, v, ro, rl, do, scale, causal, segs,
                                  off)[0]
    one = single_key_rows(b, sq, sk, causal, segs, off, device)
    split = fa._split_segments(segs, sq, sk)
    seen = torch.stack([fa._visible(i, sq, sk, causal, off, split,
                                    device).sum(dim=1) for i in range(b)])
    assert torch.equal(one, seen == 1) and one.any()
    dq64, bound = single_key_fp64(q, k, v, do, one, causal, segs, off,
                                  scale)
    ratio = ((got[one].double() - dq64).abs() / bound).max().item()
    return got, want, one, seen == 0, ratio


@pytest.mark.parametrize("case", DQ_EDGE_CASES)
def test_flash_dq_wgmma_single_key_and_empty_rows(cuda_device, case):
    """The bf16 split dq on wgmma: every row within the bf16 gate of the
    plain version; a query row that sees exactly one key (p = 1, dp =
    delta, so dq = 0 up to rounding) within the derived rounding bound of
    an fp64 plain version (``chip_smoke.single_key_ulps``, the smoke's
    rule since it moved off a floor at the fp32 noise); rows that see no
    key give dq = 0 exactly."""
    got, want, one, none, ratio = _single_key_dq(case, cuda_device)
    assert ratio <= 1.0
    assert torch.count_nonzero(got[none]).item() == 0
    keep = ~(one | none)
    _assert_close(got[keep], want[keep], (-1,), True, 1e-3, "dq")


def test_flash_dq_single_key_bound_refuses_a_bf16_delta(cuda_device):
    """The planted fault: the split dq fed delta rounded to bf16 (what a
    kernel that kept delta in bf16 would read) leaves the single-key rows
    over the bound, on the edge cases taken together."""
    ratios = [_single_key_dq(case, cuda_device, torch.bfloat16)[4]
              for case in DQ_EDGE_CASES]
    assert max(ratios) > 1.0, ratios


def test_flash_dispatch_takes_the_byte_rule_on_cuda(cuda_device):
    q, k, v, do, *_ = _flash_inputs(FLASH_CASES[0], "bf16", cuda_device)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    counts = (fa.flash_bwd_fused_cuda.launches, fa.flash_bwd_dq_cuda.launches)
    out = fa.flash_attention(q, k, v, causal=True)
    torch.autograd.grad(out, (q, k, v), do)
    assert fa.flash_bwd_fused_cuda.launches == counts[0] + 1   # sk*d small
    assert fa.flash_bwd_dq_cuda.launches == counts[1]


@pytest.mark.parametrize("sk,fused", [(200, True), (2816, False)])
def test_flash_dispatch_pads_a_head_dim_once(cuda_device, sk, fused):
    """Head dim 96 through the autograd op: the backward pads q, k, v,
    out and do to 128 once for whichever path the byte rule picks (fused
    at sk 200, split at 2816 in fp32) and cuts the gradients back."""
    case = (1, sk, sk, 2, 96, True, None, 0)
    q, k, v, do, _, _, _, scale = _flash_inputs(case, "fp32", cuda_device)
    wrappers = (fa.flash_bwd_fused_cuda, fa.flash_bwd_dq_cuda,
                fa.flash_bwd_dkv_cuda)
    n0 = [w.launches for w in wrappers]
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = fa.flash_attention(qg, kg, vg, causal=True)
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    torch.cuda.synchronize()
    assert [w.launches - n for w, n in zip(wrappers, n0)] == \
        ([1, 0, 0] if fused else [0, 1, 1])
    ro, rl = fa.flash_fwd_reference(q, k, v, scale, True)
    want = fa.flash_bwd_reference(q, k, v, ro, rl, do, scale, True)
    _assert_close(out, ro, (3,), False, 1e-4, "out")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.is_contiguous(), name
        _assert_close(g, w, (3,), False, 1e-3, name)


def test_flash_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q, k, v, do, *_ = _flash_inputs(FLASH_CASES[0], "fp32", cuda_device)
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_fwd_cuda(q.half(), k.half(), v.half(), 0.1, True)
    # every head dim runs: 264 on the wide route (padded to 384), cut back
    wide = q.new_zeros(q.shape[:3] + (264,))
    out, lse = fa.flash_fwd_cuda(wide, wide, wide, 0.1, True)
    assert out.shape == wide.shape and not out.any()
    assert torch.isfinite(lse).all()
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


# the wgmma route (bf16 pages, d_c a multiple of 64 up to 512, d_r 0 or
# 64): head counts 12 and 32; contexts 0 (a padding row), 1, page edges (64,
# 65, 128) and 4096 (decode rows split into many slices); a chunk beside
# decode rows; page size 8 (boxes of 8 positions) and 16; a 4-token row
# whose first queries see nothing of the last slice; odd d_c / 64
WGMMA_CASES = [
    ([1, 1, 1, 1, 0, 1, 40], [4096, 64, 65, 1, 0, 128, 300], 64, 64, 32, 512,
     64, 64),
    ([1, 1, 1, 1, 0, 1, 40], [4096, 64, 65, 1, 0, 128, 300], 64, 64, 12, 256,
     0, 64),
    ([1, 2, 4, 1], [500, 130, 257, 1], 8, 64, 12, 256, 0, 8),
    ([3, 0, 0, 7], [20, 0, 0, 7], 4, 8, 12, 256, 0, 8),
    ([1, 5, 0, 6], [13, 10, 0, 6], 3, 16, 32, 512, 64, 8),
    ([40, 1, 3], [40, 130, 3], 3, 64, 12, 192, 64, 40),
    ([1, 1, 37], [300, 64, 200], 5, 64, 5, 64, 0, 64),
    ([1, 1, 37], [300, 64, 200], 5, 64, 4, 448, 64, 64),
]


@pytest.mark.parametrize("case", WGMMA_CASES)
def test_latent_wgmma_route_matches_plain_version(cuda_device, case):
    """bf16 pages at the covered widths launch the wgmma kernel (and only
    it) and meet the fp32 gate: q and p in two bf16 terms, exact bf16
    pages, fp32 sums."""
    d_c, d_r = case[5], case[6]
    assert rpa.latent_route(None, torch.bfloat16, d_c, d_r, case[3],
                            len(case[0])) == "wgmma"
    args, kw, mask = _latent_inputs(case, "bf16", cuda_device)
    fn = rpa.latent_ragged_paged_attention_cuda
    before = (fn.launches, fn.wgmma_launches)
    got = rpa.latent_ragged_paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert (fn.launches, fn.wgmma_launches) == (before[0] + 1, before[1] + 1)
    want = rpa.latent_ragged_paged_attention_reference(*args, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    over = ((got - want).abs() - 1e-4 * (1 + want.abs()))[mask]
    assert over.max().item() <= 0, over.max().item()
    assert torch.count_nonzero(got[~mask]).item() == 0
    # deterministic: the same inputs give the same bits
    again = rpa.latent_ragged_paged_attention(*args, **kw)
    assert torch.equal(again, got)


# every other page kind and width, and bf16 pages at covered widths that
# the wgmma route does not take: page sizes 4, 12 and 2 (TMA boxes of 8
# positions would cross pages), and more rows than a block keeps item
# offsets of
MMA_SYNC_CASES = [
    (kind, ([1, 5, 0, 6], [13, 10, 0, 6], 3, 8, 4, d_c, d_r, 8))
    for kind, d_c, d_r in [("bf16", 16, 4), ("bf16", 128, 32),
                           ("bf16", 576, 0), ("fp32", 256, 0),
                           ("int8", 256, 0), ("nf4", 256, 0)]] + [
    ("bf16", ([1, 1, 0, 1, 40], [300, 64, 0, 1, 129], 76, 4, 32, 512, 64,
              40)),
    ("bf16", ([1, 1, 0, 1, 40], [300, 64, 0, 1, 129], 26, 12, 12, 256, 0,
              40)),
    ("bf16", ([1, 2, 4, 1], [13, 10, 5, 1], 7, 2, 12, 256, 0, 4)),
    ("bf16", ([1] * 1025, [3] * 1025, 1, 8, 4, 64, 0, 1)),
]


@pytest.mark.parametrize(
    "kind,case", MMA_SYNC_CASES,
    ids=[f"{k}-dc{c[5]}-dr{c[6]}-ps{c[3]}-rows{len(c[0])}"
         for k, c in MMA_SYNC_CASES])
def test_latent_other_kinds_and_widths_stay_on_mma_sync(cuda_device, kind,
                                                        case):
    """Every other page kind, width, page size and batch runs the split
    TF32 kernel (the wgmma counter does not move) and meets the fp32
    gate, with the padding tokens zero."""
    quant, dtype = LATENT_KINDS[kind]
    dtype = dtype or (torch.int8 if quant == "int8" else torch.uint8)
    d_c, d_r = case[5], case[6]
    assert rpa.latent_route(quant, dtype, d_c, d_r, case[3],
                            len(case[0])) == "mma.sync"
    if d_c > 512:
        return  # not covered by either route: refused below
    args, kw, mask = _latent_inputs(case, kind, cuda_device)
    fn = rpa.latent_ragged_paged_attention_cuda
    before = (fn.launches, fn.wgmma_launches)
    got = rpa.latent_ragged_paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert (fn.launches, fn.wgmma_launches) == (before[0] + 1, before[1])
    want = rpa.latent_ragged_paged_attention_reference(*args, **kw)
    over = ((got - want).abs() - 1e-4 * (1 + want.abs()))[mask]
    assert over.max().item() <= 0, over.max().item()
    assert torch.count_nonzero(got[~mask]).item() == 0


def test_latent_wgmma_route_refuses_what_it_does_not_take(cuda_device):
    # a pool that is not 16-byte aligned
    args, kw, _ = _latent_inputs(WGMMA_CASES[3], "bf16", cuda_device)
    c_pages = args[1]
    shifted = torch.empty(c_pages.numel() + 4, dtype=c_pages.dtype,
                          device=cuda_device)[4:].view(c_pages.shape)
    shifted.copy_(c_pages)
    assert shifted.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        rpa.latent_ragged_paged_attention_cuda(args[0], shifted, *args[2:],
                                               **kw)
    # the latent's width is not the absorbed query's
    with pytest.raises(ValueError, match="absorbed q width"):
        rpa.latent_ragged_paged_attention_cuda(
            args[0][..., :192].contiguous(), *args[1:], **kw)


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
    # head dims read in place at a wider template width: 80, 96, 256, 100
    # (rows not on vector boundaries: element loads) and 67 (odd)
    ([13, 5, 24], 3, 8, 8, 2, 80),
    ([300, 64, 0, 1000, 513], 16, 64, 8, 2, 96),       # split KV axis
    ([9, 17, 0, 1], 3, 8, 4, 4, 256),
    ([300, 64, 0, 1000, 513], 16, 64, 8, 8, 256),      # split KV axis
    ([19, 8], 4, 8, 4, 2, 100),
    ([1, 8, 2], 2, 4, 10, 2, 67),
    # batches of 1, 8 and 64 at Llama-3-8B's shapes (16 KV slices of 256 on
    # an H100 at batch 1 and 8, 3 at 64): slice edges (256, 257), page
    # edges (64, 65), an empty request
    ([4096], 64, 64, 32, 8, 128),
    ([4096, 256, 257, 65, 0, 64, 1, 3001], 64, 64, 32, 8, 128),
    ([(613 * i) % 4097 for i in range(64)], 64, 64, 32, 8, 128),
    # head dims above 256, and 300 (rows on 8-byte boundaries in bf16)
    ([13, 5, 0, 24], 3, 8, 8, 2, 264),
    ([300, 64, 0, 1000, 513], 16, 64, 8, 2, 320),
    ([300, 64, 0, 1000, 513], 16, 64, 8, 8, 512),
    ([19, 8, 1], 4, 8, 4, 2, 300),
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
    # every head dim runs (264: past 256, read in place)
    wide = [torch.zeros(x.shape[:-1] + (264,), device=cuda_device)
            for x in (q, kp, vp)]
    out = pa.paged_attention_decode(*wide, pt, sl)
    assert out.shape == wide[0].shape and not out.any()
    with pytest.raises(ValueError, match="must be int32"):
        pa.paged_attention_cuda(q, kp, vp, pt.long(), sl)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention_cuda(q.transpose(0, 1).contiguous().transpose(0, 1),
                                kp, vp, pt, sl)
    with pytest.raises(ValueError, match="one CUDA device"):
        pa.paged_attention_cuda(q.cpu(), kp, vp, pt, sl)


# ---------------------------------------------------------------------------
# compiled steps: the captured serving and training steps against the same
# steps run eagerly on the card (core/capture.py)
# ---------------------------------------------------------------------------

import contextlib  # noqa: E402

import hetu_tpu_torch as ht  # noqa: E402
from hetu_tpu_torch.core import capture  # noqa: E402
from hetu_tpu_torch.models import (GPTConfig, GPTLMHeadModel,  # noqa: E402
                                   mla_config)
from hetu_tpu_torch.models.convert import (load_state,  # noqa: E402
                                           random_state, state_numpy)
from hetu_tpu_torch.ops.ragged_paged_attention import (  # noqa: E402
    latent_ragged_paged_attention_cuda)
from hetu_tpu_torch.serving import Engine  # noqa: E402

TINY_LLAMA = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=4,
                  num_kv_heads=2, max_seq_len=128, sp=False, dropout=0.0,
                  position="rotary", norm="rmsnorm", activation="swiglu")
TINY_GPT2 = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=4,
                 max_seq_len=128, sp=False, dropout=0.0, position="learned",
                 norm="layernorm", activation="gelu")


def _serve_waves(cfg, state, eager):
    """Two waves of temperature-0 traffic (prompts longer than a chunk,
    decode-only steps) on one engine; tokens, compile counts after each
    wave, and the attention kernel's launches against the steps."""
    rng = np.random.RandomState(3)
    counter = latent_ragged_paged_attention_cuda if cfg.is_mla \
        else ragged_paged_attention_cuda
    eng = Engine(state, cfg, num_pages=32, page_size=16, max_batch=3,
                 chunk_size=16, device="cuda")
    counter.launches = 0
    out, counts = [], []
    with capture.eager() if eager else contextlib.nullcontext():
        for lens in ((40, 5, 17), (9, 33)):
            reqs = [eng.add_request(rng.randint(1, 97, size=n).tolist(), 6)
                    for n in lens]
            eng.run()
            out += [r.out_tokens for r in reqs]
            counts.append(eng.compile_count)
    torch.cuda.synchronize()
    return out, counts, counter.launches, eng.executable_calls


@pytest.mark.parametrize("layout", ["full_head", "mla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_captured_serving_step_equals_eager(cuda_device, dtype, layout):
    cfg = GPTConfig(**TINY_LLAMA, dtype=dtype)
    if layout == "mla":
        cfg = mla_config(cfg, kv_latent_dim=32, kv_rope_dim=8)
    state = random_state(cfg, seed=0, device="cuda", std=0.3)
    want, eager_counts, eager_launches, eager_calls = _serve_waves(
        cfg, state, eager=True)
    got, counts, launches, calls = _serve_waves(cfg, state, eager=False)
    assert got == want
    assert eager_counts == [0, 0]
    # one graph per live chunk-slot mask: decode-only and decode + chunk
    assert counts == [2, 2]
    assert launches == cfg.num_layers * calls
    assert eager_launches == cfg.num_layers * eager_calls


def _serve_spec(cfg, state, eager, spec=True):
    """Two waves of temperature-0 traffic on a spec engine (a 1-layer
    self-draft, k 3; or without ``spec``): tokens, compile counts after
    each wave, the attention kernel's launches and the calls."""
    from hetu_tpu_torch.models import draft_state_from
    from hetu_tpu_torch.serving import SpecConfig
    rng = np.random.RandomState(3)
    counter = latent_ragged_paged_attention_cuda if cfg.is_mla \
        else ragged_paged_attention_cuda
    eng = Engine(state, cfg, num_pages=32, page_size=16, max_batch=3,
                 chunk_size=16, device="cuda",
                 spec=SpecConfig(*draft_state_from(state, cfg, 1), k=3)
                 if spec else None)
    if spec:
        assert eng.spec.own_bytes == 0
    counter.launches = 0
    out, counts = [], []
    with capture.eager() if eager else contextlib.nullcontext():
        for lens in ((40, 5, 17), (9, 33)):
            reqs = [eng.add_request(rng.randint(1, 97, size=n).tolist(), 10)
                    for n in lens]
            eng.run()
            out += [r.out_tokens for r in reqs]
            counts.append(eng.compile_count)
    torch.cuda.synchronize()
    return (out, counts, counter.launches, eng.executable_calls,
            eng.metrics_summary())


@pytest.mark.parametrize("layout", ["full_head", "mla"])
def test_captured_spec_engine_equals_eager_and_nonspec(cuda_device, layout):
    """fp32 (TF32 off): the captured spec engine gives the eager spec
    engine's tokens and the non-spec engine's; it captures one unified
    graph a live mask (chunk slot, verify region: 4 at prefill_rows 1)
    and the draft's propose graph, 5 in all, none in the second wave."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(**TINY_LLAMA, dtype="float32")
    if layout == "mla":
        cfg = mla_config(cfg, kv_latent_dim=32, kv_rope_dim=8)
    state = random_state(cfg, seed=0, device="cuda", std=0.3)
    want, eager_counts, _, _, _ = _serve_spec(cfg, state, eager=True)
    got, counts, launches, calls, m = _serve_spec(cfg, state, eager=False)
    plain, _, _, _, _ = _serve_spec(cfg, state, eager=False, spec=False)
    assert got == want == plain
    assert eager_counts == [0, 0]
    assert counts == [5, 5]
    assert launches == cfg.num_layers * calls
    assert m["spec_accepted"] > 0 and m["compile_count"] == 5


def _trainer(kw, dtype, seed=0):
    with ht.graph("define_and_run", create_new=True, device="cuda",
                  seed=seed) as g:
        ids = ht.placeholder("int32", (4, 64), name="input_ids")
        labels = ht.placeholder("int32", (4, 64), name="labels")
        model = GPTLMHeadModel(GPTConfig(**kw, dtype=dtype))
        loss = model(ids, labels)
        train_op = ht.optim.AdamOptimizer(lr=1e-3).minimize(loss)
    return g, ids, labels, model, loss, train_op


def _train_steps(kw, dtype, eager, init=None, steps=3):
    g, ids, labels, model, loss, train_op = _trainer(kw, dtype)
    if init is not None:
        load_state(model, init)
    rng = np.random.RandomState(1)
    x = rng.randint(0, 97, (4, 64)).astype(np.int32)
    y = rng.randint(0, 97, (4, 64)).astype(np.int32)
    fwd = fa.flash_fwd_cuda
    fwd.launches = 0
    losses = []
    with capture.eager() if eager else contextlib.nullcontext():
        for _ in range(steps):
            l, _u = g.run(loss, [loss, train_op], {ids: x, labels: y},
                          num_micro_batches=2)
            losses.append(float(l))
    return (losses, state_numpy(model), fwd.launches, len(g._plan_pool),
            g.compile_count)


@pytest.mark.parametrize("layout", ["full_head", "mla"])
def test_shared_step_replays_each_engines_own_pages(cuda_device, layout):
    """Two engines of one layout share ONE built step (``step_fn=``), as
    cluster replicas do, stepping in turn on different traffic: each
    engine's graphs replay its own pool's pages (tokens equal to the same
    traffic on an engine of its own, eager), each engine counts its own
    two graphs and the step four, and a two-replica ``EngineCluster``
    equals a monolithic engine."""
    from hetu_tpu_torch.serving import EngineCluster
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(**TINY_LLAMA, dtype="float32")
    if layout == "mla":
        cfg = mla_config(cfg, kv_latent_dim=32, kv_rope_dim=8)
    state = random_state(cfg, seed=0, device="cuda", std=0.3)
    kw = dict(num_pages=32, page_size=16, max_batch=3, chunk_size=16)
    rng = np.random.RandomState(5)
    traffic = [[rng.randint(1, 97, size=n).tolist() for n in lens]
               for lens in ((40, 5, 17), (9, 33, 21))]
    want = []
    for prompts in traffic:
        eng = Engine(state, cfg, device="cuda", **kw)
        with capture.eager():
            reqs = [eng.add_request(p, 6) for p in prompts]
            eng.run()
        want.append([r.out_tokens for r in reqs])
    a = Engine(state, cfg, device="cuda", **kw)
    b = Engine(state, cfg, device="cuda", step_fn=a._step_fn, **kw)
    assert b._step_fn is a._step_fn
    got = []
    for eng, prompts in ((a, traffic[0]), (b, traffic[1])):
        got.append([eng.add_request(p, 6) for p in prompts])
    while a.has_work or b.has_work:          # the replicas step in turn
        for eng in (a, b):
            if eng.has_work:
                eng.step()
    torch.cuda.synchronize()
    assert [[r.out_tokens for r in reqs] for reqs in got] == want
    assert a.compile_count == b.compile_count == 2
    assert a._step_fn.compile_count == 4
    prompts = traffic[0] + traffic[1]
    mono = Engine(state, cfg, device="cuda", **kw)
    mreqs = [mono.add_request(p, 6) for p in prompts]
    mono.run()
    cl = EngineCluster(state, cfg, num_replicas=2, coordinator=False,
                       policy="load", device="cuda", **kw)
    creqs = [cl.add_request(p, 6) for p in prompts]
    cl.run()
    cl.close()
    assert {r.replica for r in creqs} == {0, 1}
    assert [r.out_tokens for r in creqs] == [r.out_tokens for r in mreqs]
    assert [r.engine.compile_count for r in cl.replicas] == [2, 2]


@pytest.mark.parametrize("which,dtype", [("llama", "float32"),
                                         ("gpt2", "bfloat16")])
def test_captured_training_step_equals_eager(cuda_device, which, dtype):
    kw = TINY_LLAMA if which == "llama" else TINY_GPT2
    init = state_numpy(_trainer(kw, dtype)[3])
    want, want_w, eager_launches, _, eager_graphs = _train_steps(
        kw, dtype, eager=True, init=init)
    got, got_w, launches, plans, graphs = _train_steps(
        kw, dtype, eager=False, init=init)
    assert got == want and np.isfinite(got).all() and got[-1] < got[0]
    for name in want_w:
        np.testing.assert_array_equal(got_w[name], want_w[name],
                                      err_msg=name)
    assert plans == 1 and graphs == 1 and eager_graphs == 0
    assert launches == eager_launches == kw["num_layers"] * 2 * 3


def test_captured_dropout_draws_fresh_masks(cuda_device):
    """dropout 0.1: every replay draws new masks (a forward-only plan
    gives a new loss each run), and the captured runs give the eager
    runs' losses from the same generator seed."""
    kw = dict(TINY_GPT2, dropout=0.1)
    if not capture.can_capture_generators():
        g, ids, labels, _, loss, _ = _trainer(kw, "float32")
        x = np.ones((4, 64), np.int32)
        with pytest.raises(RuntimeError, match="frozen mask"):
            g.run([loss], feed_dict={ids: x, labels: x})
        return
    runs = {}
    init = None
    for eager in (True, False):
        g, ids, labels, model, loss, train_op = _trainer(kw, "float32")
        # materializing the seeded init draws from the graph's generator
        # on both sides, so both start their masks from one state
        weights = state_numpy(model)
        init = weights if init is None else init
        load_state(model, init)
        x = np.random.RandomState(2).randint(0, 97, (4, 64)).astype(np.int32)
        feeds = {ids: x, labels: x}
        with capture.eager() if eager else contextlib.nullcontext():
            fwd = [float(g.run([loss], feed_dict=feeds)[0])
                   for _ in range(3)]
            trained = [float(g.run(loss, [loss, train_op], feeds,
                                   num_micro_batches=2)[0])
                       for _ in range(3)]
        runs[eager] = fwd, trained, g.compile_count
    (ef, et, eg), (cf, ct, cg) = runs[True], runs[False]
    assert len(set(cf)) == 3 and len(set(ct)) == 3
    assert eg == 0 and cg == 2
    np.testing.assert_allclose(cf, ef, rtol=1e-6)
    np.testing.assert_allclose(ct, et, rtol=1e-6)


# ---------------------------------------------------------------------------
# the training recipe in a captured step: a GradScaler skip and a
# scheduled lr inside replays, recompute (graph/amp.py, graph/recompute.py)
# ---------------------------------------------------------------------------

def _recipe_trainer(kw, make_opt, scaler=None, init=None):
    # one seed for every graph: equal dropout streams across them
    with ht.graph("define_and_run", create_new=True, device="cuda",
                  seed=0) as g:
        ids = ht.placeholder("int32", (4, 64), name="input_ids")
        labels = ht.placeholder("int32", (4, 64), name="labels")
        model = GPTLMHeadModel(GPTConfig(**kw, dtype="bfloat16"))
        loss = model(ids, labels)
        opt = make_opt()
        op = opt.minimize(loss, grad_scaler=scaler)
    if init is not None:
        load_state(model, init)
    x = np.random.RandomState(5).randint(0, 97, (4, 64)).astype(np.int32)
    return g, model, opt, lambda: g.run(loss, [loss, op],
                                        {ids: x, labels: x})[0]


def test_captured_scaler_skip_and_scheduled_lr(cuda_device):
    """One captured step replayed: the lr of each replay is the schedule's
    at that replay's step; an infinity written into an embedding element
    the step reads makes a replay skip (parameters, Adam's moments and
    step bitwise unchanged, the scale halved); restored, the next replay
    updates.  The captured losses equal an eager run's."""
    sched = ht.optim.cosine_schedule(1e-3, 2, 6, 1e-4)
    make = lambda: ht.optim.AdamOptimizer(lr=sched)   # noqa: E731
    init = state_numpy(_recipe_trainer(TINY_GPT2, make)[1])
    runs = {}
    for eager in (True, False):
        scaler = ht.GradScaler(init_scale=256.0, growth_interval=100)
        g, model, opt, step = _recipe_trainer(TINY_GPT2, make, scaler, init)
        losses, lrs = [], []
        with capture.eager() if eager else contextlib.nullcontext():
            for i in range(5):
                if i == 3:
                    wte = model.transformer.wte.weight.get_data()
                    keep = wte[0, 0].clone()
                    with torch.no_grad():
                        wte[0, 0] = float("inf")
                    before = ({n: v.clone()
                               for n, v in model.state_dict().items()},
                              {t: m.clone() for t, m in opt._state["m"].items()},
                              {t: v.clone() for t, v in opt._state["v"].items()},
                              opt._state["step"].clone())
                losses.append(float(step()))
                lrs.append(float(opt._lr_at(opt._state["step"])))
                if i == 3:
                    assert all(torch.equal(v, before[0][n])
                               for n, v in model.state_dict().items())
                    assert all(torch.equal(m, before[1][t])
                               for t, m in opt._state["m"].items())
                    assert all(torch.equal(v, before[2][t])
                               for t, v in opt._state["v"].items())
                    assert torch.equal(opt._state["step"], before[3])
                    assert scaler.scale == 128.0
                    with torch.no_grad():
                        wte[0, 0] = keep
        runs[eager] = losses, lrs, g.compile_count, float(opt._state["step"])
    (el, elr, eg, es), (cl, clr, cg, cs) = runs[True], runs[False]
    assert eg == 0 and cg == 1 and es == cs == 4.0
    assert not np.isfinite(cl[3]) and np.isfinite(cl[4])
    assert clr == elr and clr[3] == clr[2]
    np.testing.assert_allclose(clr[:3], [float(sched(float(s)))
                                         for s in (1, 2, 3)], rtol=1e-6)
    np.testing.assert_allclose(np.array(cl)[[0, 1, 2, 4]],
                               np.array(el)[[0, 1, 2, 4]], rtol=1e-6)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_captured_recompute_equals_the_plain_step(cuda_device, dropout):
    """Captured steps under ``recompute`` (both policies): the plain
    step's losses and weights, every attention forward run twice; with
    dropout the recomputation reuses the forward's masks."""
    kw = dict(TINY_GPT2, dropout=dropout)
    make = lambda: ht.optim.AdamOptimizer(lr=1e-3)   # noqa: E731
    init = state_numpy(_recipe_trainer(kw, make)[1])
    runs = {}
    for policy in (None, "nothing_saveable", "dots_saveable"):
        g, model, opt, step = _recipe_trainer(kw, make, init=init)
        fa.flash_fwd_cuda.launches = 0
        with ht.recompute(policy, graph=g) if policy else \
                contextlib.nullcontext():
            losses = [float(step()) for _ in range(3)]
        runs[policy] = (losses, state_numpy(model),
                        fa.flash_fwd_cuda.launches, g.compile_count)
    base, base_w, base_fwd, _ = runs[None]
    assert base_fwd == TINY_GPT2["num_layers"] * 3
    for policy in ("nothing_saveable", "dots_saveable"):
        losses, w, fwd, graphs = runs[policy]
        assert losses == base and graphs == 1 and fwd == 2 * base_fwd
        for n in base_w:
            np.testing.assert_array_equal(w[n], base_w[n], err_msg=n)


# ---------------------------------------------------------------------------
# the numeric sentry in a captured training step
# ---------------------------------------------------------------------------

def _sentry_trainer():
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
    with ht.graph("define_and_run", create_new=True, device="cuda",
                  seed=0) as g:
        ids = ht.placeholder("int32", (4, 64), name="input_ids")
        labels = ht.placeholder("int32", (4, 64), name="labels")
        model = GPTLMHeadModel(GPTConfig(
            vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=64, dtype="float32"))
        loss = model(ids, labels)
        opt = optim.AdamOptimizer(lr=1e-2, sentry=True)
        op = opt.minimize(loss)
    rng = np.random.RandomState(7)
    toks = [rng.randint(0, 97, (4, 65)).astype(np.int32) for _ in range(5)]

    def step(i):
        l, _ = g.run(loss, [loss, op], {ids: toks[i][:, :-1],
                                        labels: toks[i][:, 1:]})
        return float(l)
    return g, opt, step


def _held(g, opt):
    out = [v.clone() for v in g._var_data.values()]
    for v in opt._state.values():
        out += [x.clone() for x in (v.values() if isinstance(v, dict)
                                    else [v])]
    return out


def test_sentry_poisoned_replay_leaves_no_residue(cuda_device):
    """Each poisoned replay of the captured step (grad_nan, grad_spike)
    leaves every variable, Adam moment and the step count ``torch.equal``
    to its state before, captures nothing new, and copies one tensor to
    the host, as a clean step does; the clean steps equal a run that
    never saw the poison, bitwise."""
    g, opt, step = _sentry_trainer()
    losses = [step(0), step(1)]
    assert (g.compile_count, g.captures_total) == (1, 1)
    saved = torch.Tensor.cpu
    reads = []

    def cpu(t, *a, **k):
        if t.is_cuda:
            reads.append(1)
        return saved(t, *a, **k)
    for i, kind in ((2, "grad_nan"), (3, "grad_spike")):
        before = _held(g, opt)
        g.inject_numeric_fault(kind)
        torch.Tensor.cpu = cpu
        try:
            step(i)
        finally:
            torch.Tensor.cpu = saved
        v = opt.sentry.last_verdict()
        assert v["anomaly"], v
        assert all(torch.equal(a, b) for a, b in zip(before, _held(g, opt)))
        assert (g.compile_count, g.captures_total) == (1, 1)
    assert len(reads) == 2
    losses.append(step(4))
    g2, _, step2 = _sentry_trainer()
    assert [step2(i) for i in (0, 1, 4)] == losses
    assert g.last_run_captured and g2.compile_count == 1
