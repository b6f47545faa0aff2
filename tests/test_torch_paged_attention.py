"""The port's paged decode attention against the JAX package, on the CPU.

The same numpy inputs, drawn from a seed, go through the JAX reference,
the Pallas kernel in interpret mode and the port's plain PyTorch version
(the cases of tests/test_serving.py's paged attention tests: GQA and MHA,
partial last pages, shuffled page tables with trash-page tails).
Tolerance: fp32, rtol = atol = 2e-5 (the three differ only in the order
of fp32 sums).
"""
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


@pytest.mark.parametrize("hd", [80, 96, 256])
@pytest.mark.parametrize("case", ["gqa_shuffled", "one_token_contexts"])
def test_plain_version_matches_jax_at_wide_head_dims(case, hd):
    """Head dims that the card's kernel runs at a wider template width (80
    and 96 at 128) or at its widest (256)."""
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
