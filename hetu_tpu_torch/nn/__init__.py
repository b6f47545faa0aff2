"""Modules of the port (``hetu_tpu.nn`` counterpart): the containers, the
standard layers and the model-parallel layers at one device."""
from .layers import (AvgPool2d, BatchNorm2d, BCELoss, Conv2d,
                     CrossEntropyLoss, Dropout, Embedding, GELU, GeLU,
                     Identity, KLDivLoss, LayerNorm, LeakyReLU, Linear,
                     MaxPool2d, MSELoss, NLLLoss, ReLU, RMSNorm, Sigmoid, SiLU,
                     Softmax, Tanh)
from .module import Module, ModuleDict, ModuleList, Sequential
from .parallel import (ColumnParallelLinear, ParallelLayerNorm,
                       ParallelRMSNorm, RowParallelLinear,
                       VocabParallelEmbedding, sharded,
                       vocab_parallel_cross_entropy)

__all__ = [
    "Module", "Sequential", "ModuleList", "ModuleDict",
    "Linear", "Embedding", "LayerNorm", "RMSNorm", "BatchNorm2d", "Conv2d",
    "MaxPool2d", "AvgPool2d", "Dropout", "Identity", "ReLU", "GeLU", "GELU",
    "SiLU", "Tanh", "Sigmoid", "LeakyReLU", "Softmax",
    "NLLLoss", "CrossEntropyLoss", "MSELoss", "BCELoss", "KLDivLoss",
    "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
    "ParallelLayerNorm", "ParallelRMSNorm", "vocab_parallel_cross_entropy",
    "sharded",
]
