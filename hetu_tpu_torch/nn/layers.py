"""Standard layers (counterpart of ``hetu_tpu.nn.layers``): Linear, conv,
norm, embedding, dropout, activation and loss modules over graph
parameters, with the JAX package's parameter names, shapes and
initializers."""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from ..graph.ctor import (ConstantInitializer, HeUniformInitializer,
                          NormalInitializer, UniformInitializer, parameter)
from ..graph.tensor import Tensor
from ..ops import functional as ops
from .module import Module


class Linear(Module):
    """y = x W^T + b, the weight stored [out_features, in_features]."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=None, name: str = "linear"):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = parameter(
            HeUniformInitializer(), (out_features, in_features), dtype=dtype,
            name=f"{name}.weight")
        if bias:
            self.bias = parameter(
                UniformInitializer(1.0 / math.sqrt(in_features)),
                (out_features,), dtype=dtype, name=f"{name}.bias")
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return ops.linear(x, self.weight, self.bias, trans_b=True)

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}"


class Embedding(Module):
    def __init__(self, num_embeddings: int, embedding_dim: int, dtype=None,
                 name: str = "embedding"):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = parameter(NormalInitializer(0.0, 1.0),
                                (num_embeddings, embedding_dim), dtype=dtype,
                                name=f"{name}.weight")

    def forward(self, ids):
        return ops.embedding_lookup(self.weight, ids)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class LayerNorm(Module):
    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 eps: float = 1e-5, dtype=None, name: str = "ln"):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        self.weight = parameter(ConstantInitializer(1.0),
                                self.normalized_shape, dtype=dtype,
                                name=f"{name}.weight")
        self.bias = parameter(ConstantInitializer(0.0),
                              self.normalized_shape, dtype=dtype,
                              name=f"{name}.bias")

    def forward(self, x):
        return ops.layer_norm(x, self.weight, self.bias, self.eps)


class RMSNorm(Module):
    def __init__(self, dim: int, eps: float = 1e-6, dtype=None,
                 name: str = "rmsnorm"):
        super().__init__()
        self.eps = eps
        self.weight = parameter(ConstantInitializer(1.0), (dim,), dtype=dtype,
                                name=f"{name}.weight")

    def forward(self, x):
        return ops.rms_norm(x, self.weight, self.eps)


class BatchNorm2d(Module):
    """BatchNorm with running statistics, kept as fp32 buffers.

    Training normalizes with the batch statistics.  The running
    statistics move (by ``momentum``, towards the biased batch variance,
    as in the JAX package) when the forward runs at once: in an eager
    graph (``graph("eager")``), as the JAX package's eager graph moves
    them, or on torch tensors with no graph.  A forward recorded on a
    define-and-run graph, and so its runs and captured replays, leaves
    them as they are; for such loops call :meth:`update_stats` with
    fetched batch statistics (``ops.batch_norm_stats``)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, dtype=None, name: str = "bn"):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = parameter(ConstantInitializer(1.0), (num_features,),
                                dtype=dtype, name=f"{name}.weight")
        self.bias = parameter(ConstantInitializer(0.0), (num_features,),
                              dtype=dtype, name=f"{name}.bias")
        self.register_buffer("running_mean", np.zeros(num_features,
                                                      np.float32))
        self.register_buffer("running_var", np.ones(num_features, np.float32))

    def update_stats(self, batch_mean, batch_var) -> None:
        m = self.momentum
        for name, batch in (("running_mean", batch_mean),
                            ("running_var", batch_var)):
            cur = self._buffers[name]
            batch = torch.as_tensor(batch).detach().to(cur.device, cur.dtype)
            self._buffers[name] = (1 - m) * cur + m * batch

    def forward(self, x):
        if self.training:
            out = ops.batch_norm(x, self.weight, self.bias, training=True,
                                 eps=self.eps)
            mean, var = ops.batch_norm_stats(x)
            if isinstance(mean, Tensor) and mean._data is not None:
                self.update_stats(mean._data, var._data)    # eager graph
            elif isinstance(mean, torch.Tensor):            # no graph
                self.update_stats(mean, var)
            return out
        # host arrays, as the JAX package's buffers are: constants of a
        # recorded op, tensors on x's device of an op that runs at once
        return ops.batch_norm(x, self.weight, self.bias,
                              self.running_mean.numpy(),
                              self.running_var.numpy(), training=False,
                              eps=self.eps)


class Conv2d(Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Sequence[int]], stride=1, padding=0,
                 bias: bool = True, dtype=None, name: str = "conv"):
        super().__init__()
        k = (kernel_size, kernel_size) if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self.stride, self.padding = stride, padding
        self.weight = parameter(HeUniformInitializer(),
                                (out_channels, in_channels, *k), dtype=dtype,
                                name=f"{name}.weight")
        if bias:
            bound = 1.0 / math.sqrt(in_channels * k[0] * k[1])
            self.bias = parameter(UniformInitializer(bound), (out_channels,),
                                  dtype=dtype, name=f"{name}.bias")
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return ops.conv2d(x, self.weight, self.bias, self.stride,
                          self.padding)


class MaxPool2d(Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size, self.stride, self.padding = \
            kernel_size, stride, padding

    def forward(self, x):
        return ops.max_pool(x, self.kernel_size, self.stride, self.padding)


class AvgPool2d(Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size, self.stride, self.padding = \
            kernel_size, stride, padding

    def forward(self, x):
        return ops.avg_pool(x, self.kernel_size, self.stride, self.padding)


class Dropout(Module):
    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return ops.dropout(x, self.p, training=self.training)


class Identity(Module):
    def forward(self, x):
        return x


class ReLU(Module):
    def forward(self, x):
        return ops.relu(x)


class GeLU(Module):
    def forward(self, x):
        return ops.gelu(x)


GELU = GeLU


class SiLU(Module):
    def forward(self, x):
        return ops.silu(x)


class Tanh(Module):
    def forward(self, x):
        return ops.tanh(x)


class Sigmoid(Module):
    def forward(self, x):
        return ops.sigmoid(x)


class LeakyReLU(Module):
    def __init__(self, alpha: float = 0.01):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return ops.leaky_relu(x, self.alpha)


class Softmax(Module):
    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return ops.softmax(x, self.axis)


class NLLLoss(Module):
    def __init__(self, reduction: str = "mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, log_probs, target):
        return ops.nll_loss(log_probs, target, self.reduction)


class CrossEntropyLoss(Module):
    def __init__(self, reduction: str = "mean", ignore_index=None):
        super().__init__()
        self.reduction = reduction
        self.ignore_index = ignore_index

    def forward(self, logits, target):
        return ops.softmax_cross_entropy(logits, target, self.reduction,
                                         self.ignore_index)


class MSELoss(Module):
    def __init__(self, reduction: str = "mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, pred, target):
        return ops.mse_loss(pred, target, self.reduction)


class BCELoss(Module):
    def __init__(self, reduction: str = "mean", with_logits: bool = False):
        super().__init__()
        self.reduction = reduction
        self.with_logits = with_logits

    def forward(self, pred, target):
        return ops.binary_cross_entropy(pred, target, self.reduction,
                                        self.with_logits)


class KLDivLoss(Module):
    def __init__(self, reduction: str = "mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, log_probs, target):
        return ops.kl_div(log_probs, target, self.reduction)
