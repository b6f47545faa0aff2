"""Variable-sequence-length buckets: padding and packing with cu_seqlens.

Counterpart of the reference's Hydraulis bucket utilities
(``examples/hydraulis/data_utils/bucket.py``: ``Bucket.pad_data`` /
``pack_data`` building padded or packed batches + per-row ``cu_seqlens``
for varlen flash attention, ``get_sorted_batch_and_len``,
``get_input_and_label_buckets``).

Packed rows feed the attention op's segment ids; alignment keeps row
lengths on fixed multiples (static shape buckets).  Numpy only: a copy of
``hetu_tpu.data.bucket``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def _align_up(x: int, a: int) -> int:
    return (x + a - 1) // a * a


def ffd_pack(seqlens: Sequence[int], max_seqlen: int, alignment: int
             ) -> List[List[int]]:
    """First-fit-decreasing packing of (aligned) sequence lengths into
    rows of ``max_seqlen``; returns per-row index groups.  Shared by
    :meth:`Bucket.pack_data` and the JAX package's dispatcher
    (``planner.dispatch.batching_strategy``)."""
    order = sorted(range(len(seqlens)), key=lambda i: -seqlens[i])
    groups: List[List[int]] = []
    room: List[int] = []
    for i in order:
        n = _align_up(int(seqlens[i]), alignment)
        assert n <= max_seqlen, \
            f"sequence {i} (aligned {n}) exceeds max_seqlen {max_seqlen}"
        for gi, g in enumerate(groups):
            if room[gi] >= n:
                g.append(i)
                room[gi] -= n
                break
        else:
            groups.append([i])
            room.append(max_seqlen - n)
    return groups


class Bucket:
    """Collects variable-length sequences, then materializes either a
    padded batch (one row per sequence) or a packed batch (greedy
    first-fit-decreasing into rows of ``max_seqlen``) with cu_seqlens."""

    def __init__(self, pad_token: int, max_seqlen: int, alignment: int = 128):
        self.pad_token = pad_token
        self.max_seqlen = _align_up(max_seqlen, alignment)
        self.alignment = alignment
        self._seqs: List[np.ndarray] = []      # valid tokens only
        self._padded: Optional[np.ndarray] = None
        self._padded_cu: List[np.ndarray] = []
        self._packed: Optional[np.ndarray] = None
        self._packed_cu: List[np.ndarray] = []
        self._packed_lens: List[np.ndarray] = []

    def add_data(self, sequence: np.ndarray, valid_tokens: int) -> None:
        seq = np.asarray(sequence).reshape(-1)[:valid_tokens]
        assert len(seq) <= self.max_seqlen, \
            f"sequence of {len(seq)} tokens exceeds bucket max " \
            f"{self.max_seqlen}"
        self._seqs.append(seq.astype(np.int64))

    # -- padded layout -----------------------------------------------------

    def pad_data(self) -> None:
        """One sequence per row, padded to the aligned max length."""
        rows, cus = [], []
        for seq in self._seqs:
            row = np.full(self.max_seqlen, self.pad_token, np.int64)
            row[:len(seq)] = seq
            rows.append(row)
            cus.append(np.asarray([0, len(seq)], np.int32))
        self._padded = np.stack(rows) if rows else \
            np.zeros((0, self.max_seqlen), np.int64)
        self._padded_cu = cus

    # -- packed layout -----------------------------------------------------

    def pack_data(self, batching_option_matrix: Optional[np.ndarray] = None
                  ) -> None:
        """Pack sequences into rows of ``max_seqlen``.

        With ``batching_option_matrix`` [num_rows, num_seqs] (0/1: row
        assignment, e.g. from the Hydraulis ILP dispatcher), rows follow
        the matrix; otherwise greedy first-fit-decreasing.
        """
        if batching_option_matrix is not None:
            mat = np.asarray(batching_option_matrix)
            if mat.shape[1] != len(self._seqs):
                raise ValueError(
                    f"batching_option_matrix has {mat.shape[1]} columns "
                    f"for {len(self._seqs)} sequences")
            cover = mat.sum(axis=0)
            bad = np.nonzero(cover != 1)[0]
            if bad.size:
                raise ValueError(
                    f"batching_option_matrix must assign each sequence to "
                    f"exactly one row; sequences {bad.tolist()[:8]} are "
                    f"covered {cover[bad].tolist()[:8]} times")
            groups = [[j for j in range(mat.shape[1]) if mat[i, j]]
                      for i in range(mat.shape[0])]
            groups = [g for g in groups if g]
        else:
            groups = ffd_pack([len(s) for s in self._seqs],
                              self.max_seqlen, self.alignment)
        # validate capacity before writing anything (matters for
        # caller-provided assignment matrices)
        for gi, g in enumerate(groups):
            need = sum(_align_up(len(self._seqs[i]), self.alignment)
                       for i in g)
            if need > self.max_seqlen:
                raise ValueError(
                    f"packed row {gi} needs {need} aligned tokens, exceeds "
                    f"max_seqlen {self.max_seqlen}")
        rows, cus, lens = [], [], []
        for g in groups:
            row = np.full(self.max_seqlen, self.pad_token, np.int64)
            cu = [0]
            ln = []
            off = 0
            for i in g:
                seq = self._seqs[i]
                row[off:off + len(seq)] = seq
                off = _align_up(off + len(seq), self.alignment)
                cu.append(off)
                ln.append(len(seq))
            rows.append(row)
            cus.append(np.asarray(cu, np.int32))
            lens.append(np.asarray(ln, np.int32))
        self._packed = np.stack(rows) if rows else \
            np.zeros((0, self.max_seqlen), np.int64)
        self._packed_cu = cus
        self._packed_lens = lens

    # -- accessors (reference property surface) ----------------------------

    @property
    def original_batch_size(self) -> int:
        return len(self._seqs)

    @property
    def padded_batch_size(self) -> int:
        assert self._padded is not None, "call pad_data() first"
        return len(self._padded)

    @property
    def packed_batch_size(self) -> int:
        assert self._packed is not None, "call pack_data() first"
        return len(self._packed)

    @property
    def padded_batch(self) -> np.ndarray:
        assert self._padded is not None, "call pad_data() first"
        return self._padded

    @property
    def padded_cu_seqlens_list(self) -> List[np.ndarray]:
        return self._padded_cu

    @property
    def packed_batch(self) -> np.ndarray:
        assert self._packed is not None, "call pack_data() first"
        return self._packed

    @property
    def packed_cu_seqlens_list(self) -> List[np.ndarray]:
        return self._packed_cu

    @property
    def packed_valid_lens_list(self) -> List[np.ndarray]:
        """Per packed row: each doc's VALID token count (cu offsets are
        alignment-padded; doc k occupies [cu[k], cu[k]+lens[k]))."""
        return self._packed_lens


def _valid_lens(batch: np.ndarray, pad_token: int) -> np.ndarray:
    """Per-row valid length = non-pad PREFIX length (position after the
    last non-pad token), so a legitimate in-vocab token equal to
    pad_token mid-sequence doesn't shrink the count."""
    S = batch.shape[1]
    nonpad = batch != pad_token
    has_any = nonpad.any(axis=1)
    last = S - np.argmax(nonpad[:, ::-1], axis=1)
    return np.where(has_any, last, 0)


def get_sorted_batch_and_len(global_batch: np.ndarray, pad_token: int
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Sort a padded [B, S] batch by valid length ascending; returns
    (sorted_batch, sorted_valid_lens) (reference bucket.py:119)."""
    batch = np.asarray(global_batch)
    valid = _valid_lens(batch, pad_token)
    order = np.argsort(valid, kind="stable")
    return batch[order], valid[order]


def build_fake_batch_and_len(fake_seqlens: Sequence[int], pad_token: int,
                             vocab_size: int = 100, seed: int = 0
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic padded batch with the given valid lengths (reference
    bucket.py:128 — used for dispatcher testing/profiling)."""
    rng = np.random.RandomState(seed)
    S = max(fake_seqlens)
    rows = []
    for n in fake_seqlens:
        row = np.full(S, pad_token, np.int64)
        row[:n] = rng.randint(1, vocab_size, n)
        rows.append(row)
    batch = np.stack(rows)
    return batch, np.asarray(fake_seqlens)


def get_input_and_label_buckets(global_batch: np.ndarray, pad_token: int,
                                batch_indices: Sequence[int],
                                max_seqlen: int, alignment: int = 128
                                ) -> Tuple[Bucket, Bucket]:
    """Build (input, label) buckets for the selected rows: labels are the
    inputs shifted by one (reference bucket.py:142)."""
    batch = np.asarray(global_batch)
    valid = _valid_lens(batch, pad_token)
    in_bucket = Bucket(pad_token, max_seqlen, alignment)
    lb_bucket = Bucket(pad_token, max_seqlen, alignment)
    for i in batch_indices:
        n = int(valid[i])
        seq = batch[i, :n]
        in_bucket.add_data(seq[:-1], n - 1)
        lb_bucket.add_data(seq[1:], n - 1)
    return in_bucket, lb_bucket
