"""PyTorch/CUDA port of hetu_tpu.

The package mirrors ``hetu_tpu`` module for module
(``hetu_tpu_torch/X/y.py`` ports ``hetu_tpu/X/y.py``) and imports
neither JAX nor the JAX package.  Plain tensor code is PyTorch; every
Pallas TPU kernel on a ported path is a CUDA C++ kernel for Hopper
(``csrc/``), built with ``nvcc`` at first use and bound with ``ctypes``.

Entry points take an explicit ``device=`` that defaults to ``"cuda"``
and raise when no card is present, unless the caller asked for
``"cpu"``: on CPU tensors each kernel wrapper runs its plain PyTorch
version, on CUDA tensors it launches the kernel or raises.
"""
from .core.device import resolve_device, torch_dtype

__all__ = ["resolve_device", "torch_dtype"]
