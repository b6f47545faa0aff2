"""Flat dp-sharded optimizer state (counterpart of
``hetu_tpu.optim.flat_state``): ZeRO with a reduce-scatter-only sync.

The coalesced reduce-scatter (``parallel.comm.reduce_scatter_coalesced``)
hands each rank a contiguous chunk of every bucket, and chunk boundaries
do not follow parameter rows.  So the fp32 master copy and the moments
live in per-bucket flat buffers of the very same geometry: bucket
planning over the parameters in sync order (ascending tensor id, the
one order every consumer shares), ``device_num * chunk`` elements a
bucket with ``chunk = quantized_chunk(numel, n, block)``, zero padding
past the packed parameters.  Rank ``r`` keeps chunk ``r`` only: its
update is local elementwise math with no regather of the gradients.

``index`` maps ``param key -> (bucket, offset, numel, shape)`` for
checkpoints (per-parameter entries, interchangeable with the
per-parameter path).
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch

from ..parallel.comm import (INT8_BLOCK, CoalescedLayout, plan_buckets,
                             quantized_chunk)


def sync_order(xs):
    """The one gradient-sync order: ascending tensor id."""
    return sorted(xs, key=lambda t: t.id)


class FlatStateLayout:
    """Static geometry of a flat dp-sharded optimizer-state set."""

    def __init__(self, entries: Sequence[Tuple[Any, Sequence[int], Any]],
                 device_num: int, bucket_mb: float = 4.0,
                 block: int = INT8_BLOCK):
        self.entries = [(k, tuple(int(d) for d in shape), dt)
                        for k, shape, dt in entries]
        self.device_num = int(device_num)
        self.block = int(block)
        self.bucket_mb = float(bucket_mb)
        self.buckets = tuple(plan_buckets(self.entries, bucket_mb))
        self.chunks = tuple(
            quantized_chunk(sum(b.numels), self.device_num, self.block)
            for b in self.buckets)
        self.index: Dict[Any, Tuple[int, int, int, Tuple[int, ...]]] = {}
        for bi, b in enumerate(self.buckets):
            off = 0
            for k, shape, numel in zip(b.keys, b.shapes, b.numels):
                self.index[k] = (bi, off, numel, shape)
                off += numel

    @property
    def padded_sizes(self) -> Tuple[int, ...]:
        """Global flat length of each bucket (``device_num * chunk``)."""
        return tuple(self.device_num * c for c in self.chunks)

    def comm_layout(self) -> CoalescedLayout:
        """The layout ``reduce_scatter_coalesced`` returns for the same
        entries, without running one (ZeRO-3 gathers the working
        parameters from the master chunks with it)."""
        return CoalescedLayout(tuple(self.buckets), tuple(self.chunks),
                               False)

    def pack(self, values: Dict[Any, torch.Tensor],
             dtype=torch.float32) -> List[torch.Tensor]:
        """``{key: tensor}`` -> per-bucket flat buffers, zero-padded."""
        flats = []
        for b, size in zip(self.buckets, self.padded_sizes):
            flat = torch.cat([values[k].reshape(-1).to(dtype)
                              for k in b.keys])
            flats.append(torch.nn.functional.pad(
                flat, (0, size - flat.shape[0])))
        return flats

    def unpack(self, flats: Sequence[torch.Tensor]) -> Dict[Any, torch.Tensor]:
        """Per-bucket flat buffers -> ``{key: tensor}`` (padding dropped)."""
        out: Dict[Any, torch.Tensor] = {}
        for b, flat in zip(self.buckets, flats):
            off = 0
            for k, shape, numel in zip(b.keys, b.shapes, b.numels):
                out[k] = flat[off:off + numel].reshape(shape)
                off += numel
        return out
