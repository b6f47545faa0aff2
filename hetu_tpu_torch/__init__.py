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

and so do models built from ``nn``'s layers (``nn.Linear``,
``nn.Conv2d``, ``nn.Sequential``, ...) and ``ops.functional``'s ops, the
models of ``models`` (GPT/LLaMA, BERT, CNNs, RNNs, CTR), and the recipe
around them: ``ht.autocast``, ``ht.GradScaler``,
``ht.recompute``, ``ht.cpu_offload``, the lr schedules and optimizers of
``optim``, ``data.Dataloader`` and ``utils.checkpoint``; the training
entry point is ``examples/train_gpt_torch.py``.
"""
from . import nn, optim
from .core.device import resolve_device
from .core.dtype import torch_dtype
from .graph import (parallel_parameter, parallel_placeholder, parameter,
                    placeholder)
from .graph.amp import GradScaler, autocast
from .graph.ctor import (ConstantInitializer, HeNormalInitializer,
                         HeUniformInitializer, NormalInitializer,
                         ProvidedInitializer, TruncatedNormalInitializer,
                         UniformInitializer, XavierNormalInitializer,
                         XavierUniformInitializer)
from .graph.graph import graph
from .graph.recompute import cpu_offload, recompute

__all__ = ["ConstantInitializer", "GradScaler", "HeNormalInitializer",
           "HeUniformInitializer", "NormalInitializer", "ProvidedInitializer",
           "TruncatedNormalInitializer", "UniformInitializer",
           "XavierNormalInitializer", "XavierUniformInitializer", "autocast",
           "cpu_offload", "graph", "nn", "optim", "parallel_parameter",
           "parallel_placeholder", "parameter", "placeholder", "recompute",
           "resolve_device", "torch_dtype"]
