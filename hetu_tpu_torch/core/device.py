"""Device and dtype resolution for the port's entry points.

Every entry point (``Engine``, ``generate``, the weight converter)
takes ``device=`` defaulting to ``"cuda"``.  A missing card is an
error, never a silent move to the CPU: the CPU is used only when the
caller names it.
"""
from __future__ import annotations

from typing import Union

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """``torch.device`` for ``device`` (``None`` means ``"cuda"``).
    Raises ``RuntimeError`` when a CUDA device is asked for and none is
    available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """``GPTConfig.dtype`` string -> ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; have "
                         f"{sorted(_DTYPES)}") from None
