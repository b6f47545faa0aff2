"""CTR models (counterpart of ``hetu_tpu.models.ctr``): Wide & Deep,
DeepFM and Deep & Cross over sparse fields in one shared embedding
table and dense features.  The JAX package's pluggable embedding
backends (the cached and host-served tables) come with ROADMAP queue 1
item 17; any port module that maps [B, F] ids to [B, F, D] can be
passed as ``embedding``.  Reshapes leave the batch axis free (-1), so the
graph's micro-batches run the same ops."""
from __future__ import annotations

from typing import Optional, Sequence

from ..graph.ctor import ConstantInitializer, parameter
from ..nn import Embedding, Linear, Module, ModuleList, ReLU, Sequential
from ..ops import functional as ops


class MLP(Module):
    def __init__(self, dims: Sequence[int], activate_last: bool = False,
                 name: str = "mlp"):
        super().__init__()
        layers = []
        for i in range(len(dims) - 1):
            layers.append(Linear(dims[i], dims[i + 1]))
            if i < len(dims) - 2 or activate_last:
                layers.append(ReLU())
        self.net = Sequential(*layers)

    def forward(self, x):
        return self.net(x)


class _CTRBase(Module):
    """Sparse field embeddings (one table over all fields, ids offset per
    field, the Criteo layout) beside dense features."""

    def __init__(self, num_sparse_fields: int, vocab_size: int,
                 embedding_dim: int, num_dense: int,
                 embedding: Optional[Module] = None):
        super().__init__()
        self.num_sparse_fields = num_sparse_fields
        self.embedding_dim = embedding_dim
        self.num_dense = num_dense
        self.embedding = embedding if embedding is not None else \
            Embedding(vocab_size, embedding_dim)

    def embed(self, sparse_ids):
        """[B, F] ids -> [B, F, D] embeddings."""
        return self.embedding(sparse_ids)


def _flat(e):
    """[B, F, D] -> [B, F * D]."""
    return ops.reshape(e, (-1, e.shape[1] * e.shape[2]))


class WDL(_CTRBase):
    """Wide & Deep: a linear 'wide' part and an MLP 'deep' part over the
    flattened embeddings and the dense features."""

    def __init__(self, num_sparse_fields: int, vocab_size: int,
                 embedding_dim: int = 16, num_dense: int = 13,
                 hidden: Sequence[int] = (256, 256, 256),
                 embedding: Optional[Module] = None):
        super().__init__(num_sparse_fields, vocab_size, embedding_dim,
                         num_dense, embedding)
        flat = num_sparse_fields * embedding_dim
        self.wide = Linear(flat + num_dense, 1)
        self.deep = MLP([flat + num_dense, *hidden, 1])

    def forward(self, sparse_ids, dense):
        e = self.embed(sparse_ids)
        x = ops.concat([_flat(e), dense], axis=1)
        return self.wide(x) + self.deep(x)


class DeepFM(_CTRBase):
    """DeepFM: a first-order linear term, the second-order FM
    interactions and a deep MLP."""

    def __init__(self, num_sparse_fields: int, vocab_size: int,
                 embedding_dim: int = 16, num_dense: int = 13,
                 hidden: Sequence[int] = (256, 256),
                 embedding: Optional[Module] = None):
        super().__init__(num_sparse_fields, vocab_size, embedding_dim,
                         num_dense, embedding)
        # the first-order term projects the same embedding output, so a
        # backend that remaps ids stays consistent
        flat = num_sparse_fields * embedding_dim
        self.first_order = Linear(flat, 1, bias=False)
        self.deep = MLP([flat + num_dense, *hidden, 1])
        self.dense_linear = Linear(num_dense, 1)

    def forward(self, sparse_ids, dense):
        e = self.embed(sparse_ids)                       # [B, F, D]
        flat = _flat(e)
        first = self.first_order(flat) + self.dense_linear(dense)
        # second order: 0.5 * ((sum e)^2 - sum e^2)
        s = ops.reduce_sum(e, axis=1)                    # [B, D]
        fm = 0.5 * ops.reduce_sum(s * s - ops.reduce_sum(e * e, axis=1),
                                  axis=1, keepdims=True)
        deep = self.deep(ops.concat([flat, dense], axis=1))
        return first + fm + deep


class CrossLayer(Module):
    """One DCN cross layer: x_{l+1} = x0 * (w^T x_l) + b + x_l."""

    def __init__(self, dim: int):
        super().__init__()
        self.w = Linear(dim, 1, bias=False)
        self.b = parameter(ConstantInitializer(0.0), (dim,), name="cross.b")

    def forward(self, x0, xl):
        return x0 * self.w(xl) + (self.b + xl)


class DCN(_CTRBase):
    """Deep & Cross: a feature-cross tower and a deep tower,
    concatenated into the head."""

    def __init__(self, num_sparse_fields: int, vocab_size: int,
                 embedding_dim: int = 16, num_dense: int = 13,
                 num_cross: int = 3, hidden: Sequence[int] = (256, 256),
                 embedding: Optional[Module] = None):
        super().__init__(num_sparse_fields, vocab_size, embedding_dim,
                         num_dense, embedding)
        dim = num_sparse_fields * embedding_dim + num_dense
        self.crosses = ModuleList([CrossLayer(dim) for _ in range(num_cross)])
        self.deep = MLP([dim, *hidden], activate_last=True)
        self.head = Linear(dim + hidden[-1], 1)

    def forward(self, sparse_ids, dense):
        e = self.embed(sparse_ids)
        x0 = ops.concat([_flat(e), dense], axis=1)
        xl = x0
        for cross in self.crosses:
            xl = cross(x0, xl)
        return self.head(ops.concat([xl, self.deep(x0)], axis=1))


def ctr_loss(logits, labels):
    """Binary cross entropy with logits, as every CTR model trains."""
    return ops.binary_cross_entropy(ops.reshape(logits, (-1,)), labels,
                                    with_logits=True)
