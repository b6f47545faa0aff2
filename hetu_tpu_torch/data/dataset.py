"""Datasets: torch-style map datasets + the GPT token datasets.

Counterparts of the reference's data utilities
(``python/hetu/utils/data/``, ``examples/gpt/data_utils/gpt_seq_dataset.py``
json+tokenizer GPT dataset, ``examples/hydraulis/data_utils/llama_dataset.py``).
Numpy only: a copy of ``hetu_tpu.data.dataset``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, List, Optional, Sequence

import numpy as np


class Dataset:
    """Map-style dataset."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int):
        raise NotImplementedError


class TensorDataset(Dataset):
    """Tuple-of-arrays dataset (rows indexed together)."""

    def __init__(self, *arrays: np.ndarray):
        assert arrays and all(len(a) == len(arrays[0]) for a in arrays)
        self.arrays = [np.asarray(a) for a in arrays]

    def __len__(self):
        return len(self.arrays[0])

    def __getitem__(self, idx):
        out = tuple(a[idx] for a in self.arrays)
        return out[0] if len(out) == 1 else out


class GPTSeqDataset(Dataset):
    """Fixed-length causal-LM windows over a flat token stream
    (reference GPTSeqDataset pattern: doc tokens -> seq_len windows with
    next-token labels)."""

    def __init__(self, tokens: np.ndarray, seq_len: int,
                 stride: Optional[int] = None):
        self.tokens = np.asarray(tokens, np.int32).reshape(-1)
        self.seq_len = seq_len
        self.stride = stride or seq_len
        n = (len(self.tokens) - 1 - seq_len)
        self.num = max(0, n // self.stride + 1)

    def __len__(self):
        return self.num

    def __getitem__(self, idx):
        s = idx * self.stride
        x = self.tokens[s:s + self.seq_len]
        y = self.tokens[s + 1:s + self.seq_len + 1]
        return x, y

    def as_matrix(self) -> np.ndarray:
        """All (input, label) rows as one [N, 2*seq_len] int32 matrix —
        the fixed-stride layout the native prefetch loader consumes."""
        out = np.empty((self.num, 2 * self.seq_len), np.int32)
        for i in range(self.num):
            x, y = self[i]
            out[i, :self.seq_len] = x
            out[i, self.seq_len:] = y
        return out


class GPTJsonDataset(Dataset):
    """JSON-lines text corpus tokenized to fixed-length rows (reference
    ``examples/gpt/data_utils/gpt_seq_dataset.py``: web json docs ->
    tokenize -> pad/concat to seq_len).

    ``tokenizer`` is any callable text -> list[int]; pass e.g. a
    HuggingFace tokenizer's ``encode``.
    """

    def __init__(self, json_file: str, key: str, seq_len: int,
                 tokenizer: Callable[[str], List[int]],
                 pad_id: int = 0, cache_path: Optional[str] = None):
        self.seq_len = seq_len
        self.pad_id = pad_id
        if cache_path is not None and not cache_path.endswith(".npy"):
            cache_path += ".npy"  # np.save appends it; keep paths in sync
        if cache_path is not None and os.path.exists(cache_path):
            self.data = np.load(cache_path)
        else:
            rows = []
            with open(json_file) as f:
                for line in f:
                    if not line.strip():
                        continue
                    doc = json.loads(line)[key]
                    ids = list(tokenizer(doc))[:seq_len]
                    ids = ids + [pad_id] * (seq_len - len(ids))
                    rows.append(ids)
            self.data = np.asarray(rows, np.int32)
            if cache_path is not None:
                np.save(cache_path, self.data)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return self.data[idx]
