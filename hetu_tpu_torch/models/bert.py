"""BERT (counterpart of ``hetu_tpu.models.bert``).

A bidirectional transformer encoder with token, position and segment
embeddings, the post-norm block of the original BERT, masked-LM and
next-sentence pre-training heads and a sequence-classification head,
built from the port's model-parallel layers at one device, with the JAX
package's parameter names (``bert.blocks{i}.attn.qkv``, ...).  Its
reshapes leave the batch axis free (-1), as the GPT model's do, so the
graph's micro-batches run it (the JAX package's bakes the global batch
in, and runs whole batches only).  Attention
is ``ops.attention(..., causal=False)``: the non-causal flash kernels on
the card, the plain attention on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..graph.ctor import NormalInitializer, parallel_parameter
from ..nn import (ColumnParallelLinear, Module, ModuleList,
                  ParallelLayerNorm, RowParallelLinear,
                  VocabParallelEmbedding, vocab_parallel_cross_entropy)
from ..ops import functional as ops


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None   # None -> 4h
    max_seq_len: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.0
    init_std: float = 0.02
    dtype: str = "float32"
    dp_axis: str = "dp"
    tp_axis: str = "tp"

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class BertSelfAttention(Module):
    """Bidirectional multi-head attention."""

    def __init__(self, cfg: BertConfig, idx: int):
        super().__init__()
        self.cfg = cfg
        self.qkv = ColumnParallelLinear(
            cfg.hidden_size, 3 * cfg.hidden_size,
            init=NormalInitializer(0.0, cfg.init_std),
            name=f"bert.blocks{idx}.attn.qkv")
        self.dense = RowParallelLinear(
            cfg.hidden_size, cfg.hidden_size,
            init=NormalInitializer(0.0, cfg.init_std),
            name=f"bert.blocks{idx}.attn.dense")

    def forward(self, x):
        cfg = self.cfg
        s = x.shape[1]
        # the batch axis stays -1, so a micro-batch runs the same ops
        qkv = ops.reshape(self.qkv(x), (-1, s, 3, cfg.num_heads,
                                        cfg.head_dim))
        q = ops.getitem(qkv, (slice(None), slice(None), 0))
        k = ops.getitem(qkv, (slice(None), slice(None), 1))
        v = ops.getitem(qkv, (slice(None), slice(None), 2))
        out = ops.attention(q, k, v, causal=False)   # [b, s, nh, hd]
        return self.dense(ops.reshape(out, (-1, s, cfg.hidden_size)))


class BertLayer(Module):
    """Post-norm encoder block (the original BERT ordering)."""

    def __init__(self, cfg: BertConfig, idx: int):
        super().__init__()
        init = NormalInitializer(0.0, cfg.init_std)
        self.attn = BertSelfAttention(cfg, idx)
        self.ln1 = ParallelLayerNorm(cfg.hidden_size,
                                     name=f"bert.blocks{idx}.ln1")
        self.fc1 = ColumnParallelLinear(cfg.hidden_size, cfg.ffn_size,
                                        init=init,
                                        name=f"bert.blocks{idx}.mlp.fc1")
        self.fc2 = RowParallelLinear(cfg.ffn_size, cfg.hidden_size, init=init,
                                     name=f"bert.blocks{idx}.mlp.fc2")
        self.ln2 = ParallelLayerNorm(cfg.hidden_size,
                                     name=f"bert.blocks{idx}.ln2")

    def forward(self, x):
        x = self.ln1(x + self.attn(x))
        return self.ln2(x + self.fc2(ops.gelu(self.fc1(x))))


class BertModel(Module):
    """Embeddings, the encoder stack and the tanh pooler."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        init = NormalInitializer(0.0, cfg.init_std)
        self.wte = VocabParallelEmbedding(cfg.vocab_size, cfg.hidden_size,
                                          init=init, name="bert.wte")
        self.wpe = parallel_parameter(
            init, (cfg.max_seq_len, cfg.hidden_size), name="bert.wpe")
        self.wse = parallel_parameter(
            init, (cfg.type_vocab_size, cfg.hidden_size), name="bert.wse")
        self.ln = ParallelLayerNorm(cfg.hidden_size, name="bert.ln")
        self.blocks = ModuleList([BertLayer(cfg, i)
                                  for i in range(cfg.num_layers)])
        self.pooler = ColumnParallelLinear(
            cfg.hidden_size, cfg.hidden_size, gather_output=True, init=init,
            name="bert.pooler")

    def forward(self, input_ids, token_type_ids=None):
        cfg = self.cfg
        s = input_ids.shape[1]
        x = self.wte(input_ids)
        x = x + ops.slice(self.wpe, (0, 0), (s, cfg.hidden_size))
        if token_type_ids is not None:
            x = x + ops.embedding_lookup(self.wse, token_type_ids)
        x = self.ln(x)
        for blk in self.blocks:
            x = blk(x)
        cls = ops.getitem(x, (slice(None), 0))       # [b, h]
        return x, ops.tanh(self.pooler(cls))


class BertForPreTraining(Module):
    """Masked-LM and next-sentence heads; the MLM head is tied to the
    token embedding and ignores labels of -100."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg)
        self.nsp_head = ColumnParallelLinear(cfg.hidden_size, 2,
                                             gather_output=True,
                                             name="bert.nsp")

    def forward(self, input_ids, token_type_ids=None, mlm_labels=None,
                nsp_labels=None):
        hidden, pooled = self.bert(input_ids, token_type_ids)
        logits = ops.linear(hidden, self.bert.wte.weight, trans_b=True)
        if mlm_labels is None:
            return logits
        loss = vocab_parallel_cross_entropy(logits, mlm_labels,
                                            ignore_index=-100)
        if nsp_labels is not None:
            loss = loss + ops.softmax_cross_entropy(self.nsp_head(pooled),
                                                    nsp_labels)
        return loss


class BertForSequenceClassification(Module):
    def __init__(self, cfg: BertConfig, num_classes: int = 2):
        super().__init__()
        self.bert = BertModel(cfg)
        self.classifier = ColumnParallelLinear(
            cfg.hidden_size, num_classes, gather_output=True, name="bert.cls")

    def forward(self, input_ids, labels=None, token_type_ids=None):
        _, pooled = self.bert(input_ids, token_type_ids)
        logits = self.classifier(pooled)
        if labels is None:
            return logits
        return ops.softmax_cross_entropy(logits, labels)
