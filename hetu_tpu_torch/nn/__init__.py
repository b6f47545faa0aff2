"""Modules of the port (``hetu_tpu.nn`` counterpart): what the GPT/LLaMA
training model uses."""
from .layers import Dropout
from .module import Module, ModuleList
from .parallel import (ColumnParallelLinear, ParallelLayerNorm,
                       ParallelRMSNorm, RowParallelLinear,
                       VocabParallelEmbedding, sharded,
                       vocab_parallel_cross_entropy)

__all__ = ["ColumnParallelLinear", "Dropout", "Module", "ModuleList",
           "ParallelLayerNorm", "ParallelRMSNorm", "RowParallelLinear",
           "VocabParallelEmbedding", "sharded",
           "vocab_parallel_cross_entropy"]
