"""Ring attention: context parallelism over a mesh axis (port of
``hetu_tpu.parallel.ring_attention``).

The sequence is split over the ``cp`` axis; KV blocks travel the ring
while each rank runs flash attention (``ops.flash_attention``: kernel 1
on a CUDA tensor, its plain version on a CPU one) of its local q against
the visiting block, and merges the partial results with the online
log-sum-exp correction (``_merge``, the reference's ``ExecCorr``).

The JAX ring is one program inside ``shard_map``: a ``fori_loop`` over
``cp`` rounds, ``lax.ppermute`` hops and a ``lax.switch`` on the pair's
traced mask class.  SPMD here is by process, and each rank runs the
rounds from the host: the class of a (q-rank, kv-rank) pair is a Python
int known there, so the branch is a plain Python one, and a hop is
``comm.ring_shift`` over the cp group (staged through host memory on a
gloo mesh of CUDA tensors, ``comm.GLOO_CUDA_STAGED``; tag ``ring/kv``).
The JAX forward's last round rotates the KV once more, to where nothing
reads it; the port leaves that hop out, on every rank alike, so a
forward makes ``cp - 1`` hops of k, v (and the kv ids, when segments are
on).

The backward (``_RingAttn``, the JAX custom VJP) uses the forward's
global ``out`` and ``lse``: it runs the rounds again, sums each pair's dq
locally, and adds each pair's dk and dv to accumulators that travel with
the KV block (tag ``ring/dkv``), so that after ``cp`` hops they are back
with their owner; k, v and the ids make ``cp - 1`` hops.  The merge and
the dq, dk and dv accumulators are fp32; ``out`` is cast to q's dtype.

Split patterns (reference ``SplitPattern`` NORMAL/SYM):

- ``normal`` -- contiguous blocks.  Under a causal mask the pair classes
  are CAUSAL/FULL/EMPTY, and the last rank does about cp times rank 0's
  work.
- ``sym`` -- the global sequence is cut into ``2 * cp`` chunks and rank
  ``i`` holds chunks ``(i, 2cp-1-i)``.  The pair with itself is the
  composite causal (head-causal, and the tail causal at offset ``s/2``
  over the whole block), an earlier rank's KV is seen only in its head
  half (COL), a later rank's only by the tail q half (ROW): every (rank,
  round) does ``s_local**2 / 2`` of score work.

Packed sequences and per-rank lengths ride the same mechanism: segment
ids (global document ids, ``-1`` for padding, ``-2`` on the kv side so
that padding never matches padding) travel with their KV block and mask
the pairs whose ids differ, under both patterns.

``ring_attention`` takes the rank's local ``[b, s_local, h, d]`` block.
``ring_attention_sharded`` takes the rank's contiguous shard of the
global arrays (the JAX function takes the global arrays); under ``sym``
it moves the tokens into the sym layout over the cp group itself, where
XLA moves them in the JAX package: half ``h`` of rank ``i``'s shard is
global chunk ``c = 2i + h``, which goes to rank ``c`` if ``c < cp``, else
to rank ``2cp-1-c`` (one ``comm.permute_group`` a half, tag
``ring/sym_layout``), and back on the way out; the backward makes the
inverse hops.  The batch and head axes need nothing: the rank holds its
part of them already.

``profile_ring_breakdown`` times each round's hop (``comm_s``), pair
forward (``attn_s``), merge (``corr_s``) and pair backward (``grad_s``),
with CUDA events on the card and ``time.perf_counter`` on the CPU;
``HETU_TPU_RING_PROFILE=1`` runs it once a shape inside
``ring_attention_sharded`` and logs the table (``_FILE``: a JSONL file
through ``utils.metrics.Metrics``, one a rank, ``.rank<r>`` appended on a
mesh of several ranks; ``_BWD=0`` leaves ``grad_s`` out).
"""
from __future__ import annotations

import math
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import comm
from .mesh import current_mesh
from ..ops.flash_attention import _flash_bwd, _flash_fwd

# pair-mask classes (reference AttnMask); a pair's 0..2 index (see
# _mask_kind) means CAUSAL/FULL/EMPTY under "normal" and
# CAUSAL_SYM/COL/ROW under "sym"
CAUSAL, FULL, EMPTY, CAUSAL_SYM, COL, ROW = range(6)

SPLIT_PATTERNS = ("normal", "sym")


def _head(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The head half of ``x`` along ``dim`` (the sequence: 1; lse's: 2),
    contiguous, as the kernels take it."""
    return x.chunk(2, dim)[0].contiguous()


def _tail(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    return x.chunk(2, dim)[1].contiguous()


def _seg_slice(segs, qs, ks):
    """Slice a (q_ids, kv_ids) tuple to the given q/kv ranges; a None
    range keeps that side whole, ``segs`` None stays None (shared by the
    sym branches of the forward and the backward, so that their masks
    cannot part)."""
    if segs is None:
        return None
    q_ids, kv_ids = segs
    return (q_ids if qs is None else q_ids[:, qs].contiguous(),
            kv_ids if ks is None else kv_ids[:, ks].contiguous())


def _to_out(c: torch.Tensor) -> torch.Tensor:
    return c.transpose(1, 2)[..., None]          # [b, h, s] -> [b, s, h, 1]


def _merge(acc, o_r, lse_r):
    """Online LSE merge of one round's (normalized out, lse) into the
    accumulator ``(m, denom, out)``: m, denom and lse in [b, h, s], out
    in [b, s, h, d], all fp32.  A row empty this round (lse = -inf)
    adds nothing, and a row empty so far keeps no NaN."""
    m, denom, out = acc
    m_new = torch.maximum(m, lse_r)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    c_old = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    c_new = torch.where(torch.isfinite(lse_r), torch.exp(lse_r - m_safe),
                        0.0)
    return (m_new, denom * c_old + c_new,
            out * _to_out(c_old) + o_r * _to_out(c_new))


def _init_acc(b: int, s: int, h: int, d: int, device):
    return (torch.full((b, h, s), float("-inf"), device=device),
            torch.zeros((b, h, s), device=device),
            torch.zeros((b, s, h, d), device=device))


def _pair_class(mask_kind: int, pattern: str, causal: bool) -> int:
    if not causal:
        return FULL
    return (CAUSAL_SYM, COL, ROW)[mask_kind] if pattern == "sym" \
        else (CAUSAL, FULL, EMPTY)[mask_kind]


def _pair_fwd(q, k, v, scale, mask_kind, segs, pattern, causal):
    """(out fp32, lse) of one (q-rank, kv-rank) pair; ``segs`` is None or
    a ``(q_ids [b, s], kv_ids [b, s])`` tuple, which the sym branches
    slice to their halves."""
    b, s, h, d = q.shape
    sh = s // 2
    kind = _pair_class(mask_kind, pattern, causal)
    if kind in (CAUSAL, FULL):
        o, lse = _flash_fwd(q, k, v, scale, kind == CAUSAL, segs)
        return o.float(), lse
    if kind == EMPTY:
        return (torch.zeros((b, s, h, d), device=q.device),
                torch.full((b, h, s), float("-inf"), device=q.device))
    if kind == CAUSAL_SYM:
        # [[causal, empty], [full, causal]] on (head, tail) halves: the
        # q head against the kv head, causal; the q tail against the
        # whole block, causal at offset s/2
        o1, l1 = _flash_fwd(_head(q), _head(k), _head(v), scale, True,
                            _seg_slice(segs, slice(None, sh),
                                       slice(None, sh)))
        o2, l2 = _flash_fwd(_tail(q), k, v, scale, True,
                            _seg_slice(segs, slice(sh, None), None),
                            causal_offset=sh)
        return torch.cat([o1, o2], 1).float(), torch.cat([l1, l2], 2)
    if kind == COL:
        # every q row sees only the kv head half (an earlier chunk)
        o, lse = _flash_fwd(q, _head(k), _head(v), scale, False,
                            _seg_slice(segs, None, slice(None, sh)))
        return o.float(), lse
    # ROW: only the q tail half sees this (later) rank's kv
    o2, l2 = _flash_fwd(_tail(q), k, v, scale, False,
                        _seg_slice(segs, slice(sh, None), None))
    o = torch.cat([torch.zeros((b, sh, h, d), device=q.device), o2.float()],
                  1)
    lse = torch.cat([torch.full((b, h, sh), float("-inf"), device=q.device),
                     l2], 2)
    return o, lse


def _pair_bwd(q, k, v, do, out, lse, scale, mask_kind, segs, pattern,
              causal):
    """dq, dk, dv of one pair from the global ``out`` and ``lse``; the
    branches mirror :func:`_pair_fwd`."""
    b, s, h, d = q.shape
    sh = s // 2
    kind = _pair_class(mask_kind, pattern, causal)
    if kind in (CAUSAL, FULL):
        return _flash_bwd(scale, kind == CAUSAL, segs, (q, k, v, out, lse),
                          do)
    if kind == EMPTY:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    if kind == CAUSAL_SYM:
        dq1, dk1, dv1 = _flash_bwd(
            scale, True, _seg_slice(segs, slice(None, sh), slice(None, sh)),
            (_head(q), _head(k), _head(v), _head(out), _head(lse, 2)),
            _head(do))
        dq2, dk, dv = _flash_bwd(
            scale, True, _seg_slice(segs, slice(sh, None), None),
            (_tail(q), k, v, _tail(out), _tail(lse, 2)), _tail(do),
            causal_offset=sh)
        dk[:, :sh] += dk1
        dv[:, :sh] += dv1
        return torch.cat([dq1, dq2], 1), dk, dv
    if kind == COL:
        dq, dkh, dvh = _flash_bwd(
            scale, False, _seg_slice(segs, None, slice(None, sh)),
            (q, _head(k), _head(v), out, lse), do)
        pad = (0, 0, 0, 0, 0, s - sh)
        return (dq, torch.nn.functional.pad(dkh, pad),
                torch.nn.functional.pad(dvh, pad))
    # ROW
    dq2, dk, dv = _flash_bwd(
        scale, False, _seg_slice(segs, slice(sh, None), None),
        (_tail(q), k, v, _tail(out), _tail(lse, 2)), _tail(do))
    return torch.nn.functional.pad(dq2, (0, 0, 0, 0, sh, 0)), dk, dv


def _mask_kind(my_rank: int, kv_rank: int, causal: bool, pattern: str
               ) -> int:
    """The (q-rank, kv-rank) pair's 0..2 branch index: under "normal"
    CAUSAL/FULL/EMPTY, under "sym" CAUSAL_SYM/COL/ROW -- in both the
    self pair, an earlier rank and a later rank."""
    if not causal:
        return 0            # unused: the pair functions run it full
    if kv_rank == my_rank:
        return 0
    return 1 if kv_rank < my_rank else 2


def _ring_segs(q_ids, kv_ids, use_segs):
    return (q_ids, kv_ids) if use_segs else None


def _hop(xs, axis, mesh, tag):
    """Each tensor of ``xs`` (None passes) one place round the ring."""
    with comm.comm_tag(tag):
        return [None if x is None else comm.ring_shift(x, axis, 1, mesh)
                for x in xs]


def _ring_fwd_impl(q, k, v, seg_ids, mesh, axis, scale, causal, pattern,
                   use_segs):
    cp = comm.axis_size(axis, mesh)
    my = comm.axis_index(axis, mesh)
    b, s, h, d = q.shape
    # kv-side ids: padding (-1) maps to -2, so q padding never matches
    kv_ids = torch.where(seg_ids < 0, -2, seg_ids)
    acc = _init_acc(b, s, h, d, q.device)
    k_cur, v_cur, ids_cur = k, v, kv_ids if use_segs else None
    for r in range(cp):
        kind = _mask_kind(my, (my - r) % cp, causal, pattern)
        o_r, lse_r = _pair_fwd(q, k_cur, v_cur, scale, kind,
                               _ring_segs(seg_ids, ids_cur, use_segs),
                               pattern, causal)
        acc = _merge(acc, o_r, lse_r)
        del o_r, lse_r
        if r < cp - 1:
            k_cur, v_cur, ids_cur = _hop((k_cur, v_cur, ids_cur), axis, mesh,
                                         "ring/kv")
    m, denom, out_acc = acc
    safe = torch.where(denom == 0.0, 1.0, denom)
    out = out_acc / _to_out(safe)
    lse = torch.where(denom == 0.0, float("-inf"), m + torch.log(safe))
    return out.to(q.dtype), lse


def _ring_bwd_impl(q, k, v, seg_ids, out, lse, do, mesh, axis, scale,
                   causal, pattern, use_segs):
    cp = comm.axis_size(axis, mesh)
    my = comm.axis_index(axis, mesh)
    kv_ids = torch.where(seg_ids < 0, -2, seg_ids)
    dq = torch.zeros(q.shape, device=q.device)
    dk = torch.zeros(k.shape, device=q.device)
    dv = torch.zeros(v.shape, device=q.device)
    k_cur, v_cur, ids_cur = k, v, kv_ids if use_segs else None
    for r in range(cp):
        kind = _mask_kind(my, (my - r) % cp, causal, pattern)
        if _pair_class(kind, pattern, causal) != EMPTY:
            dq_c, dk_c, dv_c = _pair_bwd(
                q, k_cur, v_cur, do, out, lse, scale, kind,
                _ring_segs(seg_ids, ids_cur, use_segs), pattern, causal)
            dq += dq_c.float()
            dk += dk_c.float()
            dv += dv_c.float()
            del dq_c, dk_c, dv_c
        # the gradient accumulators travel with their KV block: after cp
        # hops they are back with its owner
        dk, dv = _hop((dk, dv), axis, mesh, "ring/dkv")
        if r < cp - 1:
            k_cur, v_cur, ids_cur = _hop((k_cur, v_cur, ids_cur), axis, mesh,
                                         "ring/kv")
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttn(torch.autograd.Function):
    """The ring's forward and its backward (the JAX custom VJP); segment
    ids get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seg_ids, mesh, axis, scale, causal, pattern,
                use_segs):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _ring_fwd_impl(q, k, v, seg_ids, mesh, axis, scale,
                                  causal, pattern, use_segs)
        ctx.save_for_backward(q, k, v, seg_ids, out, lse)
        ctx.args = (mesh, axis, scale, causal, pattern, use_segs)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg_ids, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd_impl(q, k, v, seg_ids, out, lse,
                                    do.to(q.dtype).contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


# ---------------------------------------------------------------------------
# sym layout helpers
# ---------------------------------------------------------------------------


def sym_indices(s_global: int, cp: int) -> np.ndarray:
    """Permutation putting the global sequence into the sym ring layout:
    2·cp chunks, rank i's shard = [chunk i, chunk 2cp-1-i]."""
    assert s_global % (2 * cp) == 0, \
        f"seq {s_global} not divisible by 2*cp={2 * cp}"
    ch = s_global // (2 * cp)
    idx = []
    for i in range(cp):
        idx.extend(range(i * ch, (i + 1) * ch))
        idx.extend(range((2 * cp - 1 - i) * ch, (2 * cp - i) * ch))
    return np.asarray(idx, dtype=np.int64)


def sym_inverse_indices(s_global: int, cp: int) -> np.ndarray:
    fwd = sym_indices(s_global, cp)
    inv = np.empty_like(fwd)
    inv[fwd] = np.arange(s_global)
    return inv


def sym_shard(x: torch.Tensor, cp: int, axis: int = 1) -> torch.Tensor:
    """A whole global tensor reordered so that contiguous cp blocks are
    the sym layout."""
    idx = torch.as_tensor(sym_indices(x.shape[axis], cp), device=x.device)
    return torch.index_select(x, axis, idx)


def sym_unshard(x: torch.Tensor, cp: int, axis: int = 1) -> torch.Tensor:
    idx = torch.as_tensor(sym_inverse_indices(x.shape[axis], cp),
                          device=x.device)
    return torch.index_select(x, axis, idx)


def sym_perms(cp: int) -> List[List[Tuple[int, int]]]:
    """The two permutations that move contiguous shards into the sym
    layout: entry ``h`` sends half ``h`` of rank ``i``'s shard, global
    chunk ``c = 2i + h``, to rank ``c`` if ``c < cp`` else ``2cp-1-c``.
    Every rank receives one even and one odd chunk, so each is a
    permutation."""
    def dst(c):
        return c if c < cp else 2 * cp - 1 - c
    return [[(i, dst(2 * i + h)) for i in range(cp)] for h in (0, 1)]


def sym_exchange(x: torch.Tensor, mesh, axis: str = "cp",
                 dim: int = 1) -> torch.Tensor:
    """The rank's contiguous shard of a sequence split over ``axis``, as
    its sym shard (head chunk ``i``, tail chunk ``2cp-1-i``); autograd
    carries the gradient back by the inverse hops."""
    cp = comm.axis_size(axis, mesh)
    if cp == 1:
        return x
    my = comm.axis_index(axis, mesh)
    with comm.comm_tag("ring/sym_layout"):
        got = [comm.permute_group(half, axis, p, mesh) for half, p in
               zip((_head(x, dim), _tail(x, dim)), sym_perms(cp))]
    # rank j's head chunk is chunk j: the even one when j is even
    head, tail = (got[0], got[1]) if my % 2 == 0 else (got[1], got[0])
    return torch.cat([head, tail], dim)


def sym_unexchange(x: torch.Tensor, mesh, axis: str = "cp",
                   dim: int = 1) -> torch.Tensor:
    """Inverse of :func:`sym_exchange`."""
    cp = comm.axis_size(axis, mesh)
    if cp == 1:
        return x
    my = comm.axis_index(axis, mesh)
    head, tail = _head(x, dim), _tail(x, dim)
    even, odd = (head, tail) if my % 2 == 0 else (tail, head)
    with comm.comm_tag("ring/sym_layout"):
        back = [comm.permute_group(part, axis, [(d, s) for s, d in p],
                                   mesh)
                for part, p in zip((even, odd), sym_perms(cp))]
    return torch.cat(back, dim)


def pair_score_area(cp: int, pattern: str, causal: bool = True
                    ) -> np.ndarray:
    """Relative attention-score work per (rank, round), in units of
    (s_local)²: under normal + causal the last rank does about cp× rank
    0's work; under sym every entry is 0.5."""
    area = np.zeros((cp, cp))
    for i in range(cp):
        for r in range(cp):
            j = (i - r) % cp
            if not causal:
                area[i, r] = 1.0
            elif pattern == "sym":
                area[i, r] = 0.5   # CAUSAL_SYM, COL and ROW all cover half
            else:
                area[i, r] = 0.5 if j == i else (1.0 if j < i else 0.0)
    return area


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _scale(q, softmax_scale):
    return softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])


def _the_mesh(mesh):
    m = mesh if mesh is not None else current_mesh()
    if m is None:
        raise ValueError("ring attention needs a mesh: pass mesh= or call "
                         "inside `with mesh:`")
    return m


def ring_attention(q, k, v, axis_name: str = "cp", causal: bool = True,
                   softmax_scale: Optional[float] = None,
                   split_pattern: str = "normal",
                   segment_ids: Optional[torch.Tensor] = None,
                   seq_len=None, mesh=None) -> torch.Tensor:
    """Ring attention on the rank's ``[b, s_local, h, d]`` block of a
    sequence split over ``axis_name`` (of ``mesh``, or the innermost
    ``with mesh:``).

    ``split_pattern``: "normal" (contiguous blocks) or "sym" (the block
    holds chunks i and 2cp-1-i: :func:`sym_exchange`).  ``segment_ids``:
    the block's ``[b, s_local]`` global document ids, ``-1`` for padding,
    in the same layout as q.  ``seq_len``: this rank's valid length
    (positions at or past it are padding), with or without
    ``segment_ids``."""
    mesh = _the_mesh(mesh)
    if split_pattern not in SPLIT_PATTERNS:
        raise ValueError(f"split_pattern must be one of {SPLIT_PATTERNS}, "
                         f"got {split_pattern!r}")
    b, s = q.shape[0], q.shape[1]
    if split_pattern == "sym" and s % 2 != 0:
        raise ValueError(f"sym split needs an even local seq, got {s}")
    if q.is_meta:
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    use_segs = segment_ids is not None or seq_len is not None
    if segment_ids is None:
        seg_ids = torch.zeros((b, s), dtype=torch.int32, device=q.device)
    else:
        seg_ids = segment_ids.to(device=q.device, dtype=torch.int32)
    if seq_len is not None:
        pos = torch.arange(s, dtype=torch.int32, device=q.device)[None, :]
        seg_ids = torch.where(pos < seq_len, seg_ids, -1)
    return _RingAttn.apply(q, k, v, seg_ids.contiguous(), mesh, axis_name,
                           _scale(q, softmax_scale), causal, split_pattern,
                           use_segs)


def ring_attention_sharded(q, k, v, mesh, axis_name: str = "cp",
                           causal: bool = True,
                           softmax_scale: Optional[float] = None,
                           batch_axis: Optional[str] = "dp",
                           head_axis: Optional[str] = "tp",
                           split_pattern: str = "normal",
                           segment_ids: Optional[torch.Tensor] = None,
                           seq_lens: Optional[Sequence[int]] = None
                           ) -> torch.Tensor:
    """Ring attention on the rank's contiguous shard ``[b, s/cp, h, d]``
    of global arrays whose sequence is split over ``axis_name`` (the
    batch over ``batch_axis`` and the heads over ``head_axis`` are the
    rank's already); the result is the rank's shard of the global
    output.

    With ``split_pattern="sym"`` the tokens move into the sym layout over
    the cp group on the way in and back on the way out.
    ``segment_ids``: the rank's shard of the global ``[b, s]`` packed
    document ids (-1 pad); under sym they follow their tokens.
    ``seq_lens``: the ``[cp]`` per-rank valid lengths (the reference's
    ``_seq_len_list``), counted in the rank's own (under sym, reordered)
    block, as in the JAX package."""
    if q.is_meta:
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    cp = mesh.axis_size(axis_name)
    _maybe_profile_ring(q, k, v, mesh, axis_name, causal, split_pattern,
                        softmax_scale)
    sym = split_pattern == "sym"
    if sym:
        q, k, v = (sym_exchange(x, mesh, axis_name) for x in (q, k, v))
    segs = None
    if segment_ids is not None or seq_lens is not None:
        b, s = q.shape[0], q.shape[1]
        segs = torch.zeros((b, s), dtype=torch.int32, device=q.device) \
            if segment_ids is None else \
            segment_ids.to(device=q.device, dtype=torch.int32)
        if sym and segment_ids is not None:
            segs = sym_exchange(segs, mesh, axis_name)
        if seq_lens is not None:
            lens = [int(n) for n in np.asarray(seq_lens).reshape(-1)]
            if len(lens) != cp:
                raise ValueError(f"seq_lens holds {len(lens)} lengths for "
                                 f"{axis_name}={cp}")
            mine = lens[comm.axis_index(axis_name, mesh)]
            pos = torch.arange(s, dtype=torch.int32, device=q.device)[None]
            segs = torch.where(pos < mine, segs, -1)
    out = ring_attention(q, k, v, axis_name, causal, softmax_scale,
                         split_pattern, segment_ids=segs, mesh=mesh)
    return sym_unexchange(out, mesh, axis_name) if sym else out


# ---------------------------------------------------------------------------
# per-round profile
# ---------------------------------------------------------------------------


def _timed(fn, reps: int, device) -> float:
    """Median seconds of ``fn`` over ``reps`` calls after one warm call:
    CUDA events on the card, ``time.perf_counter`` on the CPU."""
    fn()
    ts = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            z.record()
            z.synchronize()
            ts.append(a.elapsed_time(z) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def profile_ring_rounds(q, k, v, mesh, axis_name: str = "cp",
                        causal: bool = True,
                        split_pattern: str = "normal",
                        softmax_scale: Optional[float] = None,
                        reps: int = 3) -> List[float]:
    """The rank's measured pair-forward time of each round (seconds);
    :func:`profile_ring_breakdown` has the whole decomposition."""
    rows = profile_ring_breakdown(q, k, v, mesh, axis_name, causal,
                                  split_pattern, softmax_scale, reps,
                                  include_bwd=False)
    return [r["attn_s"] for r in rows]


@torch.no_grad()
def profile_ring_breakdown(q, k, v, mesh, axis_name: str = "cp",
                           causal: bool = True,
                           split_pattern: str = "normal",
                           softmax_scale: Optional[float] = None,
                           reps: int = 3, include_bwd: bool = True,
                           metrics=None) -> List[dict]:
    """Per-round timings of the KV ring on this rank, each phase run on
    its own (every rank of the cp group calls it: the hops are
    collective).  ``q, k, v``: the rank's contiguous shard, as
    :func:`ring_attention_sharded` takes it.

    - ``comm_s`` -- one hop of k, v and the ids (``ring/profile``)
    - ``attn_s`` -- ``_pair_fwd`` of the round's mask class
    - ``corr_s`` -- the ``_merge`` of the round's partials
    - ``grad_s`` -- ``_pair_bwd`` (with ``include_bwd``)

    A list of ``cp`` dicts, one a round.  ``metrics`` (a
    ``utils.metrics.Metrics``) records them as ``ring_{comm,attn,corr,
    grad}_s`` series, the round the step."""
    cp = mesh.axis_size(axis_name)
    my = mesh.axis_index(axis_name)
    scale = _scale(q, softmax_scale)
    if split_pattern == "sym":
        q, k, v = (sym_exchange(x, mesh, axis_name) for x in (q, k, v))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, s, h, d = q.shape
    seg0 = torch.zeros((b, s), dtype=torch.int32, device=q.device)

    def hop(kk, vv, sg):
        return _hop((kk, vv, sg), axis_name, mesh, "ring/profile")

    rows = []
    k_r, v_r, sg_r = k, v, seg0
    for r in range(cp):
        kind = _mask_kind(my, (my - r) % cp, causal, split_pattern)

        def attn():
            return _pair_fwd(q, k_r, v_r, scale, kind, None, split_pattern,
                             causal)
        o_r, lse_r = attn()
        row = {"round": r,
               "comm_s": _timed(lambda: hop(k_r, v_r, sg_r), reps,
                                q.device),
               "attn_s": _timed(attn, reps, q.device),
               "corr_s": _timed(lambda: _merge(
                   _init_acc(b, s, h, d, q.device), o_r, lse_r), reps,
                   q.device)}
        if include_bwd:
            o_q = o_r.to(q.dtype)
            row["grad_s"] = _timed(lambda: _pair_bwd(
                q, k_r, v_r, o_q, o_q, lse_r, scale, kind, None,
                split_pattern, causal), reps, q.device)
        rows.append(row)
        if metrics is not None:
            metrics.log(r, **{f"ring_{kk[:-2]}_s": vv
                              for kk, vv in row.items() if kk != "round"})
        # the next round's KV: the same hop the ring takes
        k_r, v_r, sg_r = hop(k_r, v_r, sg_r)
    return rows


def _maybe_profile_ring(q, k, v, mesh, axis_name, causal, split_pattern,
                        softmax_scale):
    """``HETU_TPU_RING_PROFILE=1``: once per (shape, pattern), the
    per-round breakdown, logged as the CP table (and through ``Metrics``
    to ``HETU_TPU_RING_PROFILE_FILE``, a file a rank)."""
    if os.environ.get("HETU_TPU_RING_PROFILE") != "1":
        return None
    if q.is_meta or (q.is_cuda and torch.cuda.is_current_stream_capturing()):
        # the graph's shape pass, or a capture: nothing to time
        return None
    cp = mesh.axis_size(axis_name)
    key = (tuple(q.shape), tuple(k.shape), causal, split_pattern, cp)
    if key in _RING_PROFILED:
        return None
    _RING_PROFILED.add(key)
    from ..utils.logging_utils import get_logger
    from ..utils.metrics import Metrics
    log = get_logger("ring_attention")
    path = os.environ.get("HETU_TPU_RING_PROFILE_FILE")
    if path and mesh.size > 1:
        path = f"{path}.rank{mesh.rank}"
    rec = Metrics(log_file=path) if path else Metrics()
    try:
        rows = profile_ring_breakdown(
            q.detach(), k.detach(), v.detach(), mesh, axis_name, causal,
            split_pattern, softmax_scale,
            include_bwd=os.environ.get("HETU_TPU_RING_PROFILE_BWD",
                                       "1") == "1",
            metrics=rec)
    finally:
        rec.close()
    cols = [c for c in ("comm_s", "attn_s", "corr_s", "grad_s")
            if c in rows[0]]
    lines = ["round " + " ".join(f"{c[:-2] + '_ms':>9}" for c in cols)]
    for row in rows:
        lines.append(f"{row['round']:5d} " + " ".join(
            f"{row[c] * 1e3:9.3f}" for c in cols))
    log.info("ring attention per-round profile (%s, cp=%d, rank %d, "
             "s_local=%d):\n%s", split_pattern, cp,
             mesh.axis_index(axis_name), q.shape[1], "\n".join(lines))
    return rows


_RING_PROFILED: set = set()
