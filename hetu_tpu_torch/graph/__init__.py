"""Graphs of the port (``hetu_tpu.graph`` counterpart)."""
from .ctor import (ConstantInitializer, HeNormalInitializer,
                   HeUniformInitializer, Initializer, NormalInitializer,
                   ProvidedInitializer, TruncatedNormalInitializer,
                   UniformInitializer, XavierNormalInitializer,
                   XavierUniformInitializer, parallel_parameter,
                   parallel_placeholder, parameter, placeholder, variable)
from .graph import (DefineAndRunGraph, DefineByRunGraph, EagerGraph, Graph,
                    OpNode, RunLevel, get_default_graph, graph, run_level)
from .tensor import DerivedDim, SymbolicDim, Tensor

__all__ = ["ConstantInitializer", "DefineAndRunGraph", "DefineByRunGraph",
           "DerivedDim", "EagerGraph", "Graph", "HeNormalInitializer",
           "HeUniformInitializer", "Initializer", "NormalInitializer",
           "OpNode", "ProvidedInitializer", "RunLevel", "SymbolicDim",
           "Tensor", "TruncatedNormalInitializer", "UniformInitializer",
           "XavierNormalInitializer", "XavierUniformInitializer",
           "get_default_graph", "graph", "parallel_parameter",
           "parallel_placeholder", "parameter", "placeholder", "run_level",
           "variable"]
