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

Training reads as in the JAX package::

    import hetu_tpu_torch as ht
    from hetu_tpu_torch import optim
    with ht.graph("define_and_run", device="cuda") as g:
        ids = ht.parallel_placeholder("int32", (8, 1024))
        ...
"""
from . import optim
from .core.device import resolve_device
from .core.dtype import torch_dtype
from .graph import graph, parallel_placeholder, placeholder

__all__ = ["graph", "optim", "parallel_placeholder", "placeholder",
           "resolve_device", "torch_dtype"]
