"""Define-and-run graph of the port (``hetu_tpu.graph`` counterpart)."""
from .ctor import (ConstantInitializer, HeNormalInitializer,
                   HeUniformInitializer, Initializer, NormalInitializer,
                   ProvidedInitializer, TruncatedNormalInitializer,
                   UniformInitializer, XavierNormalInitializer,
                   XavierUniformInitializer, parallel_parameter,
                   parallel_placeholder, parameter, placeholder)
from .graph import (DefineAndRunGraph, Graph, OpNode, RunLevel,
                    get_default_graph, graph)
from .tensor import Tensor

__all__ = ["ConstantInitializer", "DefineAndRunGraph", "Graph",
           "HeNormalInitializer", "HeUniformInitializer", "Initializer",
           "NormalInitializer", "OpNode", "ProvidedInitializer", "RunLevel",
           "Tensor", "TruncatedNormalInitializer", "UniformInitializer",
           "XavierNormalInitializer", "XavierUniformInitializer",
           "get_default_graph", "graph",
           "parallel_parameter", "parallel_placeholder", "parameter",
           "placeholder"]
