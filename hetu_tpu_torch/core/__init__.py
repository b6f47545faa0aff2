from .device import resolve_device
from .dtype import torch_dtype

__all__ = ["resolve_device", "torch_dtype"]
