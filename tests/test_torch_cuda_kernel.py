"""Card-only tests of the port's CUDA kernel against its plain version.

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
