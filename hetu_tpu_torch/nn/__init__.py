"""Modules of the port (``hetu_tpu.nn`` counterpart): the containers, the
standard layers and the model-parallel layers (TP, SP, vocab-parallel)
over the graph's mesh."""
from .layers import (AvgPool2d, BatchNorm2d, BCELoss, Conv2d,
                     CrossEntropyLoss, Dropout, Embedding, GELU, GeLU,
                     Identity, KLDivLoss, LayerNorm, LeakyReLU, Linear,
                     MaxPool2d, MSELoss, NLLLoss, ReLU, RMSNorm, Sigmoid, SiLU,
                     Softmax, Tanh)
from .module import Module, ModuleDict, ModuleList, Sequential
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
]
