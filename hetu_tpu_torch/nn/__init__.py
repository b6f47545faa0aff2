"""Modules of the port (``hetu_tpu.nn`` counterpart): the containers, the
standard layers, the model-parallel layers (TP, SP, vocab-parallel)
over the graph's mesh and the mixture-of-experts layers (EP)."""
from .layers import (AvgPool2d, BatchNorm2d, BCELoss, Conv2d,
                     CrossEntropyLoss, Dropout, Embedding, GELU, GeLU,
                     Identity, KLDivLoss, LayerNorm, LeakyReLU, Linear,
                     MaxPool2d, MSELoss, NLLLoss, ReLU, RMSNorm, Sigmoid, SiLU,
                     Softmax, Tanh)
from .module import Module, ModuleDict, ModuleList, Sequential
from .moe import (BalanceGate, Experts, HashGate, KTop1Gate, MoELayer,
                  SAMGate, TopKGate, make_moe_layer)
from .parallel import (ColumnParallelLinear, ParallelEmbedding,
                       ParallelLayerNorm, ParallelRMSNorm, RowParallelLinear,
                       VocabParallelEmbedding, config2ds,
                       parallel_data_provider, sharded,
                       vocab_parallel_cross_entropy)

__all__ = [
    "Module", "Sequential", "ModuleList", "ModuleDict",
    "Linear", "Embedding", "LayerNorm", "RMSNorm", "BatchNorm2d", "Conv2d",
    "MaxPool2d", "AvgPool2d", "Dropout", "Identity", "ReLU", "GeLU", "GELU",
    "SiLU", "Tanh", "Sigmoid", "LeakyReLU", "Softmax",
    "NLLLoss", "CrossEntropyLoss", "MSELoss", "BCELoss", "KLDivLoss",
    "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
    "ParallelEmbedding", "ParallelLayerNorm", "ParallelRMSNorm",
    "vocab_parallel_cross_entropy", "sharded", "config2ds",
    "parallel_data_provider",
    "MoELayer", "Experts", "TopKGate", "KTop1Gate", "HashGate", "SAMGate",
    "BalanceGate", "make_moe_layer",
]
