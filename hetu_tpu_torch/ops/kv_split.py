"""The KV split of the paged attention kernels: how many slices of the KV
axis a launch takes, and the zeroed output and tickets that the split-KV
decode core (``csrc/paged_decode.cuh``) merges through.  Shared by the
ragged (``ragged_paged_attention_cuda``), latent
(``latent_ragged_paged_attention_cuda``) and paged decode
(``paged_attention_cuda``) wrappers.

The slice count is a function of shapes and the card's SM count alone,
never of a tensor's values, so no call reads anything back to the host.
"""
from __future__ import annotations

from typing import Optional

import torch

# query heads of one KV head that a decode-core block holds (kCoreHeads)
CORE_HEADS = 4
# the decode core's split: blocks for about this many per SM, slices of at
# least this many positions of the page table's capacity, and at most
# kCoreMaxSplits slices (the merge keeps their weights in shared memory)
CORE_BLOCKS_PER_SM = 8
CORE_MIN_SPLIT_LEN = 256
CORE_MAX_SPLITS = 64


def kv_splits(sms: int, blocks: int, capacity: int, *, per_sm: int,
              min_len: int, most: Optional[int] = None) -> int:
    """Slices of the KV axis for a launch that has ``blocks`` blocks per
    slice on a card of ``sms`` SMs: enough for ``per_sm`` blocks an SM, but
    none shorter than ``min_len`` positions of the page table's
    ``capacity`` (``maxp * page_size``), at most ``most``, at least 1.
    Every argument is a plain int."""
    want = -(-per_sm * sms // max(1, blocks))
    n = min(want, capacity // min_len)
    if most is not None:
        n = min(n, most)
    return max(1, n)


def core_splits(sms: int, items: int, kvh: int, g: int,
                capacity: int) -> int:
    """:func:`kv_splits` of the decode core: a block per (item, KV head,
    ``CORE_HEADS`` query heads of the group) and slice."""
    return kv_splits(sms, items * kvh * -(-g // CORE_HEADS), capacity,
                     per_sm=CORE_BLOCKS_PER_SM, min_len=CORE_MIN_SPLIT_LEN,
                     most=CORE_MAX_SPLITS)


def zeros_with_tickets(like: torch.Tensor, n_tickets: int):
    """A zeroed tensor of the contiguous ``like``'s shape, dtype and
    device, and the address of ``n_tickets`` zeroed int32 tickets carved
    from the same buffer after it (16-byte aligned): one fill, no second
    tensor.  The decode core's merging blocks leave the tickets 0 again.
    The tickets live as long as the returned tensor."""
    item = like.element_size()
    n = like.numel()
    pad = -(-n * item // 16) * 16 // item
    buf = torch.zeros(pad + -(-4 * max(1, n_tickets) // item),
                      dtype=like.dtype, device=like.device)
    return (buf.as_strided(like.shape, like.stride()),
            buf.data_ptr() + pad * item)


def core_workspace(items: int, nh: int, n_splits: int, hd: int, device):
    """The fp32 slice states of a split launch in one buffer: ``(buffer,
    address of ws_acc [items, nh, n_splits, hd], address of ws_ml [items,
    nh, n_splits, 2])``, or ``(None, None, None)`` with one slice.  The
    caller keeps the buffer while the launch is enqueued."""
    if n_splits == 1:
        return None, None, None
    rows = items * nh * n_splits
    buf = torch.empty(rows * (hd + 2), dtype=torch.float32, device=device)
    return buf, buf.data_ptr(), buf.data_ptr() + rows * hd * 4
