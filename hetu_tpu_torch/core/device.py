"""Device resolution for the port's entry points.

Every entry point (``Engine``, ``generate``, the weight converter)
takes ``device=`` defaulting to ``"cuda"``.  A missing card is an
error, never a silent move to the CPU: the CPU is used only when the
caller names it.
"""
from __future__ import annotations

import functools
from typing import Union

import torch


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



@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (a kernel wrapper sizes
    its grid by it on every call, so the query is cached)."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())
