"""The port's ragged paged attention and sampler against the JAX package.

The same numpy inputs, drawn from a seed, go through the JAX reference,
the Pallas kernel in interpret mode and the port's plain PyTorch
version.  Tolerance: fp32, rtol = atol = 2e-5 on real tokens (the three
differ only in the order of fp32 sums).  Tokens that belong to no row
must be exactly 0 in the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.ops.ragged_paged_attention import (
    ragged_paged_attention_pallas as jax_pallas,
    ragged_paged_attention_reference as jax_reference)
from hetu_tpu_torch.ops.ragged_paged_attention import (
    DEFAULT_MASK_VALUE, ragged_paged_attention,
    ragged_paged_attention_reference, sample_row, sample_rows)

# (q_lens, ctx_lens, maxp, ps, nh, kvh, max_q): the four RAGGED_CASES of
# tests/test_serving_unified.py (nh 4, kvh 2, max_q 8), a g = 4 GQA
# case, and an fp32 case at max_q 16
CASES = [
    ([1, 5, 0, 6], [13, 10, 0, 6], 3, 8, 4, 2, 8),
    ([1, 1, 1, 1], [9, 3, 17, 1], 3, 8, 4, 2, 8),
    ([8, 8], [8, 24], 4, 8, 4, 2, 8),
    ([3, 0, 0, 7], [20, 0, 0, 7], 4, 8, 4, 2, 8),
    ([1, 6, 0, 4], [30, 6, 0, 12], 4, 8, 8, 2, 8),
    ([16, 1, 11], [40, 25, 11], 5, 8, 4, 2, 16),
]
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(case, hd=32, seed=0):
    q_lens, ctx_lens, maxp, ps, nh, kvh, max_q = case
    rng = np.random.RandomState(seed)
    s = len(q_lens)
    cu = np.zeros(s + 1, np.int32)
    cu[1:] = np.cumsum(q_lens)
    t = max(int(cu[-1]), 1) + 2                  # trailing padding tokens
    num_pages = 1 + sum(-(-c // ps) for c in ctx_lens) + 2
    perm = rng.permutation(np.arange(1, num_pages))
    pt = np.zeros((s, maxp), np.int32)           # padding -> trash page 0
    k = 0
    for i in range(s):
        need = -(-ctx_lens[i] // ps)
        pt[i, :need] = perm[k:k + need]
        k += need
    arrays = (rng.randn(t, nh, hd).astype(np.float32),
              rng.randn(num_pages, ps, kvh, hd).astype(np.float32),
              rng.randn(num_pages, ps, kvh, hd).astype(np.float32),
              np.asarray(q_lens, np.int32), cu, pt,
              np.asarray(ctx_lens, np.int32))
    real = np.zeros(t, bool)
    for i in range(s):
        real[cu[i]:cu[i] + q_lens[i]] = True
    return arrays, max_q, real


@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_jax_reference_and_pallas(case):
    arrays, max_q, real = _inputs(case)
    got = ragged_paged_attention_reference(
        *map(torch.from_numpy, arrays), max_q=max_q).numpy()
    jargs = tuple(map(jnp.asarray, arrays))
    ref = np.asarray(jax_reference(*jargs, max_q=max_q))
    pal = np.asarray(jax_pallas(*jargs, max_q=max_q, interpret=True))
    np.testing.assert_allclose(got[real], ref[real], **TOL)
    np.testing.assert_allclose(got[real], pal[real], **TOL)
    assert not got[~real].any(), "padding tokens must stay 0"


# head dims that the card's kernel runs at a wider template width (80 and 96
# at 128) or at its widest (256), and above 256 through the decode core
# (264, 320, 512), reading the pool in place
@pytest.mark.parametrize("hd", [80, 96, 256, 264, 320, 512])
@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[5]])
def test_plain_version_matches_jax_at_wide_head_dims(case, hd):
    arrays, max_q, real = _inputs(case, hd=hd, seed=1)
    got = ragged_paged_attention_reference(
        *map(torch.from_numpy, arrays), max_q=max_q).numpy()
    jargs = tuple(map(jnp.asarray, arrays))
    ref = np.asarray(jax_reference(*jargs, max_q=max_q))
    pal = np.asarray(jax_pallas(*jargs, max_q=max_q, interpret=True))
    assert got.shape[-1] == hd
    np.testing.assert_allclose(got[real], ref[real], **TOL)
    np.testing.assert_allclose(got[real], pal[real], **TOL)
    assert not got[~real].any(), "padding tokens must stay 0"


def test_dispatcher_runs_plain_version_for_cpu_tensors():
    arrays, max_q, _ = _inputs(CASES[0])
    t = tuple(map(torch.from_numpy, arrays))
    torch.testing.assert_close(
        ragged_paged_attention(*t, max_q=max_q),
        ragged_paged_attention_reference(*t, max_q=max_q), rtol=0, atol=0)


def test_mask_value_is_the_tpu_kernels():
    assert DEFAULT_MASK_VALUE == -0.7 * float(np.finfo(np.float32).max)


def _bad(arrays, which):
    q, kp, vp, ql, cu, pt, cl = arrays
    if which == "v_pages":
        vp = vp[:, :, :1]
    elif which == "head_dim":
        q = q[..., :16]
    elif which == "heads":
        q = q[:, :3]
    elif which == "cu_q":
        cu = cu[:-1]
    elif which == "page_tables":
        pt = pt[0]
    elif which == "ctx_lens":
        cl = cl[:-1]
    return (q, kp, vp, ql, cu, pt, cl)


@pytest.mark.parametrize("which", ["v_pages", "head_dim", "heads", "cu_q",
                                   "page_tables", "ctx_lens", "max_q"])
def test_shape_checks_raise_the_same_errors(which):
    arrays, max_q, _ = _inputs(CASES[0])
    bad = _bad(arrays, which)
    mq = 0 if which == "max_q" else max_q
    with pytest.raises(ValueError) as jax_err:
        jax_reference(*map(jnp.asarray, bad), max_q=mq)
    with pytest.raises(ValueError) as port_err:
        ragged_paged_attention_reference(
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in bad),
            max_q=mq)
    assert str(port_err.value) == str(jax_err.value)


# ---------------------------------------------------------------------------
# on-device sampler (the port keeps JAX's contract, not its random bits)
# ---------------------------------------------------------------------------

def _rows(n, temp, top_p=0.0, top_k=0, seed=3):
    return (torch.full((n,), temp), torch.full((n,), top_p),
            torch.full((n,), top_k, dtype=torch.int32),
            torch.full((n,), seed, dtype=torch.int32))


def test_sampler_draws_from_the_softmax():
    """Keyed draws over 6000 positions follow softmax(logits / T): each
    frequency within 0.025 of its probability (binomial sd <= 0.0065)."""
    n = 6000
    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0]]).repeat(n, 1)
    temps, tps, tks, seeds = _rows(n, 0.7)
    ctxs = torch.arange(n, dtype=torch.int32)
    toks = sample_rows(logits, temps, tps, tks, seeds, ctxs, sampled=True)
    freq = np.bincount(toks.numpy(), minlength=4) / n
    want = torch.softmax(logits[0] / 0.7, -1).numpy()
    np.testing.assert_allclose(freq, want, atol=0.025)


def test_sampler_truncation_and_greedy_rows():
    n = 500
    logits = torch.tensor([[0.1, 3.0, 2.9, 0.0, 2.8]]).repeat(n, 1)
    ctxs = torch.arange(n, dtype=torch.int32)
    # top_k = 2 keeps ids 1 and 2 only; top_p tiny keeps the argmax only
    toks = sample_rows(logits, *_rows(n, 1.0, top_k=2), ctxs, sampled=True)
    assert set(toks.tolist()) == {1, 2}
    toks = sample_rows(logits, *_rows(n, 1.0, top_p=1e-6), ctxs,
                       sampled=True)
    assert set(toks.tolist()) == {1}
    # greedy rows take the first maximum, like jnp.argmax
    tie = torch.tensor([[1.0, 5.0, 5.0, 0.0]])
    assert sample_rows(tie, *_rows(1, 0.0), ctxs[:1],
                       sampled=True).item() == 1
    assert sample_rows(tie, *_rows(1, 0.0), ctxs[:1],
                       sampled=False).item() == 1
    assert sample_row(tie[0], 0.0, 0.0, 0, 0, 0).item() == 1
    assert sample_row(logits[0], 1.0, 1e-6, 0, 5, 9).item() == 1


def test_sampler_draw_depends_only_on_seed_and_position():
    """The same (seed, ctx) draws the same token whatever else is in
    the batch; another seed takes another path."""
    v = 50
    g = torch.Generator().manual_seed(0)
    row = torch.randn(v, generator=g)
    ctxs = torch.arange(40, dtype=torch.int32)
    alone = [sample_rows(row[None], *_rows(1, 0.9), ctxs[i:i + 1],
                         sampled=True).item() for i in range(40)]
    batch = torch.cat([row[None].repeat(40, 1),
                       torch.randn(7, v, generator=g)])
    temps, tps, tks, seeds = _rows(47, 0.9)
    temps[40:] = 0.0                            # greedy companions
    both = sample_rows(batch, temps, tps, tks, seeds,
                       torch.cat([ctxs, torch.zeros(7, dtype=torch.int32)]),
                       sampled=True)
    assert both[:40].tolist() == alone
    other = sample_rows(row[None].repeat(40, 1), *_rows(40, 0.9, seed=4),
                        ctxs, sampled=True)
    assert other.tolist() != alone
