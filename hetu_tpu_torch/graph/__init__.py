"""Define-and-run graph of the port (``hetu_tpu.graph`` counterpart)."""
from .ctor import (ConstantInitializer, Initializer, NormalInitializer,
                   XavierNormalInitializer, parallel_parameter,
                   parallel_placeholder, parameter, placeholder)
from .graph import (DefineAndRunGraph, Graph, OpNode, RunLevel,
                    get_default_graph, graph)
from .tensor import Tensor

__all__ = ["ConstantInitializer", "DefineAndRunGraph", "Graph",
           "Initializer", "NormalInitializer", "OpNode", "RunLevel", "Tensor",
           "XavierNormalInitializer", "get_default_graph", "graph",
           "parallel_parameter", "parallel_placeholder", "parameter",
           "placeholder"]
