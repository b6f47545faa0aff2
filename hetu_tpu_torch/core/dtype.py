"""Dtype names of the port (counterpart of ``hetu_tpu.core.dtype``).

Only the names that placeholders and model configs use map to
``torch.dtype``s; any other name raises ``ValueError``.
"""
from __future__ import annotations

from typing import Union

import torch

_DTYPES = {"int32": torch.int32, "float32": torch.float32,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """Dtype name (or ``torch.dtype``) -> ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; have "
                         f"{sorted(_DTYPES)}") from None
