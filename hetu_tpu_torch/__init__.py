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

The graph layer has the JAX package's three kinds: ``graph("eager")``
runs each op as it is made (a module called on a concrete batch there
runs its forward at once, and ``BatchNorm2d`` moves its running
statistics), ``graph("define_by_run")`` computes on demand with a
cache, and ``graph("define_and_run")`` records and runs plans, with
``SymbolicDim`` placeholder dims, ``set_shape_buckets`` and the run
levels (``RunLevel``, ``run_level``).  Outside a block
``get_default_graph()`` is an eager graph on ``"cuda"``.  ``set_seed``
resets the initializers' and the graphs' dropout seed streams.

Meshes are SPMD by process (``parallel``): after
``rpc.distributed_init`` (or ``parallel.init_process_group``) each rank
builds ``graph(mesh=create_mesh({"dp": 2, "tp": 2}))`` over its local
shards; ``examples/train_gpt_torch.py --dp 2 --tp 2`` launches the ranks
itself.
"""
from . import nn, obs, optim, parallel, resilience
from .core.device import (Device, DeviceGroup, DeviceGroupUnion, DeviceType,
                          resolve_device)
from .core.dtype import (DataType, bfloat16, bool_, float4, float16, float32,
                         float64, int8, int16, int32, int64, nfloat4,
                         torch_dtype, uint8)
from .graph import (DefineAndRunGraph, DefineByRunGraph, EagerGraph, Graph,
                    RunLevel, SymbolicDim, Tensor, get_default_graph,
                    parallel_parameter, parallel_placeholder, parameter,
                    placeholder, run_level, variable)
from .graph.amp import GradScaler, autocast
from .graph.ctor import (ConstantInitializer, HeNormalInitializer,
                         HeUniformInitializer, NormalInitializer,
                         ProvidedInitializer, TruncatedNormalInitializer,
                         UniformInitializer, XavierNormalInitializer,
                         XavierUniformInitializer)
from .graph.graph import graph
from .graph.recompute import cpu_offload, recompute
from .parallel import (DistributedStates, DistributedStatesHierarchy,
                       DistributedStatesUnion, P, create_mesh)


def gradients(loss, xs):
    """Gradient tensors of ``loss`` with respect to ``xs`` (evaluated by
    ``torch.autograd.grad`` when run)."""
    g = loss.graph or get_default_graph()
    return g.make_gradients(loss, list(xs))


def set_seed(seed: int) -> None:
    """Resets the init stream (initializers without a seed of their own,
    in graphs built without one, take its seeds in creation order) and
    the stream each graph built afterwards draws its dropout seed from:
    models built after equal ``set_seed`` calls get equal weights and
    equal dropout masks.  numpy's process-global RNG is left alone."""
    import importlib
    import numpy as _np
    # ``graph`` in the package is the context class: name the modules
    ctor = importlib.import_module(f"{__name__}.graph.ctor")
    graph_module = importlib.import_module(f"{__name__}.graph.graph")
    ctor._seed_counter[0] = int(seed)
    graph_module._GRAPH_SEED_STREAM[0] = _np.random.RandomState(
        int(seed) & 0x7FFFFFFF)


__all__ = ["ConstantInitializer", "DataType", "DefineAndRunGraph",
           "DistributedStates", "DistributedStatesHierarchy",
           "DistributedStatesUnion", "P", "create_mesh", "parallel",
           "DefineByRunGraph", "Device", "DeviceGroup", "DeviceGroupUnion",
           "DeviceType", "EagerGraph", "GradScaler", "Graph",
           "HeNormalInitializer", "HeUniformInitializer", "NormalInitializer",
           "ProvidedInitializer", "RunLevel", "SymbolicDim", "Tensor",
           "TruncatedNormalInitializer", "UniformInitializer",
           "XavierNormalInitializer", "XavierUniformInitializer", "autocast",
           "bfloat16", "bool_", "cpu_offload", "float16", "float32",
           "float4", "float64", "get_default_graph", "gradients", "graph",
           "int16", "int32", "int64", "int8", "nfloat4", "nn", "optim",
           "parallel_parameter", "parallel_placeholder", "parameter",
           "placeholder", "recompute", "resolve_device", "run_level",
           "set_seed", "torch_dtype", "uint8", "variable"]
