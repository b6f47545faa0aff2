"""The port's paged decode attention against the JAX package, on the CPU.

The same numpy inputs, drawn from a seed, go through the JAX reference,
the Pallas kernel in interpret mode and the port's plain PyTorch version
(the cases of tests/test_serving.py's paged attention tests: GQA and MHA,
partial last pages, shuffled page tables with trash-page tails).
Tolerance: fp32, rtol = atol = 2e-5 (the three differ only in the order
of fp32 sums).
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.ops.paged_attention import (
    paged_attention_pallas as jax_pallas,
    paged_attention_reference as jax_reference)
import hetu_tpu_torch.ops as port_ops
from hetu_tpu_torch.ops.paged_attention import (
    paged_attention_cuda, paged_attention_decode, paged_attention_reference)

TOL = dict(rtol=2e-5, atol=2e-5)

# (nh, kvh, hd, ps, num_pages, page table, seq_lens)
CASES = {
    "gqa_shuffled": (8, 2, 16, 8, 12, [[4, 9, 0], [2, 0, 0], [7, 1, 5]],
                     [13, 5, 24]),
    "gqa_partial_page": (4, 2, 32, 8, 10, [[3, 1, 8, 0], [5, 0, 0, 0]],
                         [19, 8]),
    "mha": (4, 4, 16, 8, 9, [[6, 2, 0], [1, 8, 3]], [9, 17]),
    "one_token_contexts": (6, 2, 16, 4, 8, [[5, 0], [2, 7], [3, 0]],
                           [1, 8, 2]),
}


def _inputs(case, seed=0):
    nh, kvh, hd, ps, num_pages, pt, seq_lens = CASES[case]
    rng = np.random.RandomState(seed)
    return (rng.randn(len(seq_lens), nh, hd).astype(np.float32),
            rng.randn(num_pages, ps, kvh, hd).astype(np.float32),
            rng.randn(num_pages, ps, kvh, hd).astype(np.float32),
            np.asarray(pt, np.int32), np.asarray(seq_lens, np.int32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_jax_reference_and_pallas(case):
    arrays = _inputs(case)
    got = paged_attention_reference(*map(torch.from_numpy, arrays)).numpy()
    jargs = tuple(map(jnp.asarray, arrays))
    ref = np.asarray(jax_reference(*jargs))
    pal = np.asarray(jax_pallas(*jargs, interpret=True))
    assert got.shape == arrays[0].shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, pal, **TOL)


@pytest.mark.parametrize("hd", [80, 96, 256, 264, 320, 512])
@pytest.mark.parametrize("case", ["gqa_shuffled", "one_token_contexts"])
def test_plain_version_matches_jax_at_wide_head_dims(case, hd):
    """Head dims that the card's decode core reads in place, in 16-byte
    chunks (80, 96, 256) and past 256 (264, 320, 512)."""
    nh, kvh, _, ps, num_pages, pt, seq_lens = CASES[case]
    rng = np.random.RandomState(2)
    arrays = (rng.randn(len(seq_lens), nh, hd).astype(np.float32),
              rng.randn(num_pages, ps, kvh, hd).astype(np.float32),
              rng.randn(num_pages, ps, kvh, hd).astype(np.float32),
              np.asarray(pt, np.int32), np.asarray(seq_lens, np.int32))
    got = paged_attention_reference(*map(torch.from_numpy, arrays)).numpy()
    jargs = tuple(map(jnp.asarray, arrays))
    assert got.shape == arrays[0].shape
    np.testing.assert_allclose(got, np.asarray(jax_reference(*jargs)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_pallas(*jargs, interpret=True)), **TOL)


def test_plain_version_matches_dense_attention_per_request():
    """Gathering through the page table equals dense attention over each
    request's true history (the oracle of tests/test_serving.py), with a
    softmax scale given by the caller."""
    nh, kvh, hd, ps, num_pages, pt, seq_lens = CASES["gqa_shuffled"]
    q, kp, vp, pt, seq_lens = _inputs("gqa_shuffled", seed=3)
    got = paged_attention_reference(
        *map(torch.from_numpy, (q, kp, vp, pt, seq_lens)),
        softmax_scale=0.3).numpy()
    g = nh // kvh
    for bi, L in enumerate(seq_lens):
        k = np.repeat(kp[pt[bi]].reshape(-1, kvh, hd)[:L], g, axis=1)
        v = np.repeat(vp[pt[bi]].reshape(-1, kvh, hd)[:L], g, axis=1)
        s = np.einsum("hd,lhd->hl", q[bi], k) * 0.3
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        np.testing.assert_allclose(got[bi], np.einsum("hl,lhd->hd", p, v),
                                   rtol=1e-5, atol=1e-5)


def test_output_takes_q_dtype():
    arrays = _inputs("gqa_partial_page")
    q, kp, vp = (torch.from_numpy(a).bfloat16() for a in arrays[:3])
    pt, sl = map(torch.from_numpy, arrays[3:])
    got = paged_attention_reference(q, kp, vp, pt, sl)
    assert got.dtype == torch.bfloat16
    want = paged_attention_reference(q.float(), kp.float(), vp.float(), pt,
                                     sl)
    # one bf16 rounding of the fp32 result
    torch.testing.assert_close(got.float(), want, rtol=2.0 ** -8, atol=1e-6)


def test_dispatcher_runs_plain_version_for_cpu_tensors():
    t = tuple(map(torch.from_numpy, _inputs("mha")))
    assert port_ops.paged_attention_decode is paged_attention_decode
    torch.testing.assert_close(paged_attention_decode(*t),
                               paged_attention_reference(*t), rtol=0, atol=0)
    # the kernel's wrapper never runs the plain version instead
    with pytest.raises(ValueError, match="CUDA device"):
        paged_attention_cuda(*t)


@pytest.mark.parametrize("which,match", [
    ("head_dim", "head_dim"), ("heads", "divisible"),
    ("seq_lens", "seq_lens"), ("page_tables", "page_tables"),
    ("v_pages", "v_pages")])
def test_shape_checks_raise_the_same_errors(which, match):
    q, kp = np.zeros((2, 4, 16), np.float32), np.zeros((4, 8, 2, 16),
                                                      np.float32)
    vp, pt, sl = kp, np.zeros((2, 2), np.int32), np.zeros((2,), np.int32)
    if which == "head_dim":
        q = q[..., :8]
    elif which == "heads":
        q = q[:, :3]
    elif which == "seq_lens":
        sl = np.zeros((3,), np.int32)
    elif which == "page_tables":
        pt = pt[:1]
    elif which == "v_pages":
        vp = kp[:, :, :1]
    bad = [np.ascontiguousarray(a) for a in (q, kp, vp, pt, sl)]
    with pytest.raises(ValueError, match=match) as jax_err:
        jax_reference(*map(jnp.asarray, bad))
    with pytest.raises(ValueError, match=match) as port_err:
        paged_attention_reference(*map(torch.from_numpy, bad))
    assert str(port_err.value) == str(jax_err.value)


# ---------------------------------------------------------------------------
# the split-KV decode core (csrc/paged_decode.cuh): its arithmetic emulated
# in plain torch, and the one split helper
# ---------------------------------------------------------------------------

from hetu_tpu.ops.ragged_paged_attention import (  # noqa: E402
    ragged_paged_attention_reference as jax_ragged_reference)
from hetu_tpu_torch.ops.kv_split import (  # noqa: E402
    CORE_HEADS, CORE_MIN_SPLIT_LEN, core_splits, kv_splits,
    zeros_with_tickets)
from hetu_tpu_torch.ops.ragged_paged_attention import (  # noqa: E402
    DEFAULT_MASK_VALUE, ragged_paged_attention_reference)

H100_SMS = 132


def _core_geometry(hd, itemsize, capacity, n_splits):
    """(positions a ring stage, KV positions a slice) as ``core_geometry``
    of csrc/paged_decode.cuh computes them: rows padded to 64 bytes past a
    multiple of 128, the largest tile up to 32 whose 4 stages of K and V
    fit 96 KB, slices of ceil(capacity / n_splits) rounded up to tiles."""
    chunks = -(-hd * itemsize // 16)
    ld = (chunks * 16 + 63) // 128 * 128 + 64
    tile = 32
    while tile > 1 and 4 * 2 * tile * ld > 96 * 1024:
        tile //= 2
    return tile, -(-(-(-capacity // n_splits)) // tile) * tile


def _core_emulation(q, k, v, n_pos, tile, split_len, scale):
    """The decode core's arithmetic for one item: q [g, hd] against the
    first n_pos rows of the item's gathered k/v [capacity, hd], all fp32.
    The KV axis is cut into slices of ``split_len``; each slice runs the
    online softmax over tiles of ``tile`` positions into (max, sum,
    unnormalized output), slices past the context give nothing, and the
    live slices are merged (one live slice is written directly, none
    gives 0)."""
    states = []
    for begin in range(0, n_pos, split_len):
        end = min(n_pos, begin + split_len)
        m = torch.full((q.shape[0],), DEFAULT_MASK_VALUE)
        l = torch.zeros(q.shape[0])
        acc = torch.zeros_like(q)
        for kv0 in range(begin, end, tile):
            kv1 = min(kv0 + tile, end)
            s = (q @ k[kv0:kv1].T) * scale
            m_new = torch.maximum(m, s.max(-1).values)
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[:, None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[:, None] + p @ v[kv0:kv1]
            m = m_new
        states.append((m, l, acc))
    if not states:
        return torch.zeros_like(q)
    if len(states) == 1:
        m, l, acc = states[0]
        return acc / l[:, None]
    mm = torch.stack([st[0] for st in states]).max(0).values
    w = [torch.exp(st[0] - mm) for st in states]
    l = sum(st[1] * wi for st, wi in zip(states, w))
    acc = sum(st[2] * wi[:, None] for st, wi in zip(states, w))
    return acc / l[:, None]


# the item's context, named by what it exercises (ps 16, capacity 4096:
# 16 slices of 256 positions, tiles of 32)
CORE_CONTEXTS = {"empty": 0, "one": 1, "slice_edge": 256,
                 "past_slice_edge": 257, "page_edge_in_slice": 256 + 48,
                 "longest": 4096, "empty_trailing_slices": 100}


@pytest.mark.parametrize("ctx", sorted(CORE_CONTEXTS),
                         ids=sorted(CORE_CONTEXTS))
def test_decode_core_emulation_matches_plain_versions_and_jax(ctx):
    """The core's slices and merge, emulated, against the paged and ragged
    plain versions and the JAX references (decode rows of q_len 1), fp32
    within 2e-5 (the order of fp32 sums).  Context 0 gives the zero row of
    the TPU kernel's contract (the Pallas kernel in interpret mode, on a
    small pool), where the plain versions' all-masked softmax gives NaN or
    a mean."""
    n_pos = CORE_CONTEXTS[ctx]
    nh, kvh, hd, ps = 8, 2, 32, 16
    g = nh // kvh
    others = [1, 700, 4096]
    seq_lens = [n_pos] + others
    maxp = 4096 // ps
    rng = np.random.RandomState(7)
    num_pages = 1 + sum(-(-c // ps) for c in seq_lens)
    perm = rng.permutation(np.arange(1, num_pages))
    pt = np.zeros((len(seq_lens), maxp), np.int32)
    k0 = 0
    for i, c in enumerate(seq_lens):
        need = -(-c // ps)
        pt[i, :need] = perm[k0:k0 + need]
        k0 += need
    q = rng.randn(len(seq_lens), nh, hd).astype(np.float32)
    kp = rng.randn(num_pages, ps, kvh, hd).astype(np.float32)
    vp = rng.randn(num_pages, ps, kvh, hd).astype(np.float32)
    sl = np.asarray(seq_lens, np.int32)
    n_splits = core_splits(H100_SMS, len(seq_lens), kvh, g, maxp * ps)
    tile, split_len = _core_geometry(hd, 4, maxp * ps, n_splits)
    assert (tile, split_len) == (32, 256)
    scale = hd ** -0.5
    emu = np.zeros_like(q)
    for b in range(len(seq_lens)):
        kk = torch.from_numpy(kp[pt[b]].reshape(-1, kvh, hd))
        vv = torch.from_numpy(vp[pt[b]].reshape(-1, kvh, hd))
        for h in range(kvh):
            emu[b, h * g:(h + 1) * g] = _core_emulation(
                torch.from_numpy(q[b, h * g:(h + 1) * g]), kk[:, h],
                vv[:, h], seq_lens[b], tile, split_len, scale).numpy()
    live = sl > 0
    arrays = (q, kp, vp, pt, sl)
    want = paged_attention_reference(*map(torch.from_numpy, arrays)).numpy()
    np.testing.assert_allclose(emu[live], want[live], **TOL)
    jargs = tuple(map(jnp.asarray, arrays))
    np.testing.assert_allclose(emu[live], np.asarray(jax_reference(*jargs))
                               [live], **TOL)
    # the same requests as decode rows of the ragged contract
    cu = np.arange(len(seq_lens) + 1, dtype=np.int32)
    rargs = (q, kp, vp, np.ones(len(seq_lens), np.int32), cu, pt, sl)
    rag = ragged_paged_attention_reference(
        *map(torch.from_numpy, rargs), max_q=1).numpy()
    np.testing.assert_allclose(emu[live], rag[live], **TOL)
    np.testing.assert_allclose(
        emu[live], np.asarray(jax_ragged_reference(
            *map(jnp.asarray, rargs), max_q=1))[live], **TOL)
    if not live.all():
        assert not emu[~live].any()
        # the TPU kernel's zero row, on a pool of 4 pages a request
        small = (q[:1], kp, vp, pt[:1, :4], sl[:1])
        pal = np.asarray(jax_pallas(*map(jnp.asarray, small),
                                    interpret=True))
        np.testing.assert_array_equal(pal, np.zeros_like(pal))


@pytest.mark.parametrize("sms,blocks,capacity,per_sm,min_len,most", [
    (132, 72, 8192, 8, 256, None),       # phase 3's batch: 9 rows x 8 heads
    (132, 64, 4096, 8, 256, None),       # paged decode, batch 8
    (132, 512, 4096, 8, 256, None),      # paged decode, batch 64
    (132, 9, 8192, 2, 128, 16),          # the latent kernel's rows
    (132, 4, 100, 8, 256, None),         # a pool shorter than one slice
    (1, 10 ** 6, 10 ** 6, 8, 256, None),  # more blocks than the card holds
    (132, 1, 10 ** 6, 8, 256, 64),       # capped by `most`
])
def test_kv_splits_takes_shapes_and_keeps_slices_long(
        sms, blocks, capacity, per_sm, min_len, most):
    """The one split helper of the three wrappers: plain ints in, at least
    one slice out, and no slice shorter than its minimum (unless the pool
    itself is); the decode core's wrapper form gives the same."""
    n = kv_splits(sms, blocks, capacity, per_sm=per_sm, min_len=min_len,
                  most=most)
    assert type(n) is int and n >= 1
    assert n == 1 or capacity // n >= min_len
    assert most is None or n <= most
    assert n <= max(1, -(-per_sm * sms // blocks))
    if (per_sm, min_len, most) == (8, CORE_MIN_SPLIT_LEN, None) and \
            blocks % 2 == 0:
        # core_splits: a block per (item, KV head, CORE_HEADS query heads
        # of the group): here items of 2 KV heads of CORE_HEADS heads each
        assert core_splits(sms, blocks // 2, 2, CORE_HEADS, capacity) == n


@pytest.mark.parametrize("shape,dtype", [((3, 5, 7), torch.bfloat16),
                                         ((4, 32, 128), torch.float32)])
def test_zeros_with_tickets_gives_a_zeroed_output_and_tickets(shape, dtype):
    """One zeroed buffer: the output of ``like``'s shape, then 11 int32
    tickets at a 16-byte-aligned address past the output's bytes."""
    like = torch.ones(shape, dtype=dtype)
    out, tickets = zeros_with_tickets(like, 11)
    assert out.shape == shape and out.dtype == dtype and out.is_contiguous()
    assert not out.any()
    assert tickets % 16 == 0
    assert tickets >= out.data_ptr() + out.numel() * out.element_size()
    assert ctypes.string_at(tickets, 4 * 11) == bytes(4 * 11)
