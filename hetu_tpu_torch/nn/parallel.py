"""Model-parallel layers at one device (counterpart of
``hetu_tpu.nn.parallel``).

The layers keep the JAX package's constructor arguments (``dp_axis``,
``tp_axis``, ``seq_axis``, ``sp``) and parameter names, so a model reads
the same; at one device the partition annotations are identities
(``sharded`` returns its input).  Sharding over several cards comes with
slice 3.
"""
from __future__ import annotations

from typing import Optional

from ..ops import functional as ops
from ..graph.ctor import (ConstantInitializer, Initializer,
                          NormalInitializer, XavierNormalInitializer,
                          parallel_parameter)
from .module import Module


def sharded(t, pspec=None, tag: Optional[str] = None):
    """The identity at one device."""
    return t


class ColumnParallelLinear(Module):
    """Y = X W^T (+ b), W [out, in]."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 gather_output: bool = False, dp_axis: str = "dp",
                 tp_axis: str = "tp", seq_axis: Optional[str] = None,
                 dtype=None, init: Optional[Initializer] = None,
                 name: str = "colp"):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = parallel_parameter(
            init or XavierNormalInitializer(), (out_features, in_features),
            dtype=dtype, name=f"{name}.weight")
        if bias:
            self.bias = parallel_parameter(
                ConstantInitializer(0.0), (out_features,), dtype=dtype,
                name=f"{name}.bias")
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return ops.linear(x, self.weight, self.bias, trans_b=True)


class RowParallelLinear(Module):
    """Y = X W^T, then + b (the bias is added after the product, as after
    the tensor-parallel reduction in the JAX package)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 sp: bool = False, dp_axis: str = "dp", tp_axis: str = "tp",
                 seq_axis: Optional[str] = None, dtype=None,
                 init: Optional[Initializer] = None, name: str = "rowp"):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = parallel_parameter(
            init or XavierNormalInitializer(), (out_features, in_features),
            dtype=dtype, name=f"{name}.weight")
        if bias:
            self.bias = parallel_parameter(
                ConstantInitializer(0.0), (out_features,), dtype=dtype,
                name=f"{name}.bias")
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        out = ops.linear(x, self.weight, None, trans_b=True)
        if self.bias is not None:
            out = out + self.bias
        return out


class VocabParallelEmbedding(Module):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 dp_axis: str = "dp", tp_axis: str = "tp",
                 seq_axis: Optional[str] = None, dtype=None,
                 init: Optional[Initializer] = None,
                 name: str = "vocab_embed"):
        super().__init__()
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.weight = parallel_parameter(
            init or NormalInitializer(0.0, 0.02),
            (num_embeddings, embedding_dim), dtype=dtype, name=f"{name}.weight")

    def forward(self, ids):
        return ops.embedding_lookup(self.weight, ids)


class ParallelLayerNorm(Module):
    def __init__(self, normalized_shape, sp: bool = False,
                 dp_axis: str = "dp", tp_axis: str = "tp",
                 seq_axis: Optional[str] = None, eps: float = 1e-5,
                 dtype=None, name: str = "ln"):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.eps = eps
        self.weight = parallel_parameter(ConstantInitializer(1.0),
                                         tuple(normalized_shape), dtype=dtype,
                                         name=f"{name}.weight")
        self.bias = parallel_parameter(ConstantInitializer(0.0),
                                       tuple(normalized_shape), dtype=dtype,
                                       name=f"{name}.bias")

    def forward(self, x):
        return ops.layer_norm(x, self.weight, self.bias, self.eps)


class ParallelRMSNorm(Module):
    def __init__(self, dim: int, sp: bool = False, dp_axis: str = "dp",
                 tp_axis: str = "tp", seq_axis: Optional[str] = None,
                 eps: float = 1e-6, dtype=None, name: str = "rmsnorm"):
        super().__init__()
        self.eps = eps
        self.weight = parallel_parameter(ConstantInitializer(1.0), (dim,),
                                         dtype=dtype, name=f"{name}.weight")

    def forward(self, x):
        return ops.rms_norm(x, self.weight, self.eps)


def vocab_parallel_cross_entropy(logits, target, dp_axis: str = "dp",
                                 tp_axis: str = "tp",
                                 seq_axis: Optional[str] = None,
                                 reduction: str = "mean",
                                 ignore_index: Optional[int] = None):
    """Softmax cross entropy over the whole vocabulary."""
    return ops.softmax_cross_entropy(logits, target, reduction=reduction,
                                     ignore_index=ignore_index)
