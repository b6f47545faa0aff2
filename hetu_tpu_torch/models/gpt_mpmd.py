"""Heterogeneous MPMD-pipelined GPT: GPT-2 and LLaMA blocks as stage
programs (counterpart of ``hetu_tpu.models.gpt_mpmd``).

The model side of :mod:`hetu_tpu_torch.parallel.pipeline_mpmd`: one
forward function and parameter tree a stage, for unequal layer ranges a
stage (Malleus' ``stage_layers``) and several pipelines.  Stages are
independent programs, so the whole GPT-2 architecture runs (gelu and
biases, LayerNorm with bias, learned positions, GQA, dropout) beside the
LLaMA one.  The embedding lives on stage 0 and the head and loss on the
last stage; with ``tie_embeddings`` both carry the logical ``wte``, and
its gradients are summed by key.  Parameters are keyed by global layer
(``layer7``), so a re-layout can move them between stages.

The weights are drawn from ``np.random.RandomState(seed)`` in the JAX
model's order, so both packages start from the same numbers.  A stage
runs its layers through ``models.gpt_pipeline.block_fn`` (LayerNorm in
fp32, as the JAX MPMD model's; dropout from a generator a layer), whose
attention goes through ``ops.attention.sdpa`` (the flash kernels on the
card).  Stages on a submesh with dp or tp (the JAX package's ``meshes=``) are
ROADMAP queue 1 item 11b; registering the stages with the static
analyzer is item 18.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..parallel.pipeline_mpmd import (MPMDPipelineRuntime, Stage,
                                      _check_device, reduce_layer_grads)
from .gpt import GPTConfig
from .gpt_pipeline import _dropout, _norm, block_fn


def _block_params(p: Dict[str, Any]) -> Dict[str, Any]:
    """A layer's nested weights (``ln1: {g, b}``, the JAX MPMD model's
    tree) under :func:`block_fn`'s flat names (``ln1``, ``ln1_b``)."""
    out: Dict[str, Any] = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out[k] = v["g"]
            if "b" in v:
                out[k + "_b"] = v["b"]
        else:
            out[k] = v
    return out


def init_block_params(cfg: GPTConfig, rng: np.random.RandomState
                      ) -> Dict[str, Any]:
    """One layer's weights (numpy fp32), drawn in the JAX model's order."""
    c = cfg
    h, f = c.hidden_size, c.ffn_size
    nh, kvh, hd = c.num_heads, c.kv_heads, c.head_dim
    bias = c.activation == "gelu"
    mult = 2 if c.activation == "swiglu" else 1
    depth_std = c.init_std / math.sqrt(2 * c.num_layers)
    qkv_out = (nh + 2 * kvh) * hd

    def w(shape, std):
        return rng.normal(0.0, std, shape).astype(np.float32)

    p: Dict[str, Any] = {
        "ln1": {"g": np.ones(h, np.float32)},
        "qkv": w((qkv_out, h), c.init_std),
        "attn_out": w((h, nh * hd), depth_std),
        "ln2": {"g": np.ones(h, np.float32)},
        "mlp_up": w((mult * f, h), c.init_std),
        "mlp_down": w((h, f), depth_std),
    }
    if c.norm == "layernorm":
        p["ln1"]["b"] = np.zeros(h, np.float32)
        p["ln2"]["b"] = np.zeros(h, np.float32)
    if bias:
        p["qkv_b"] = np.zeros(qkv_out, np.float32)
        p["attn_out_b"] = np.zeros(h, np.float32)
        p["mlp_up_b"] = np.zeros(mult * f, np.float32)
        p["mlp_down_b"] = np.zeros(h, np.float32)
    return p


def _embed_apply(cfg: GPTConfig, p, ids, gen):
    x = torch.nn.functional.embedding(ids.long(), p["wte"])
    if cfg.position == "learned":
        x = x + p["wpe"][:ids.shape[1]][None]
    return _dropout(x, cfg.dropout, gen)


def _head_loss_apply(cfg: GPTConfig, p, x, labels):
    x = _norm(x, p["ln_f"]["g"], p["ln_f"].get("b"), dtype=torch.float32)
    logits = torch.matmul(x, p["wte_head"].t())
    logp = torch.log_softmax(logits.float(), -1)
    lab = labels.long()
    valid = (lab >= 0).float()
    nll = -torch.gather(logp, -1, lab.clamp_min(0)[..., None])[..., 0]
    return (nll * valid).sum() / valid.sum().clamp_min(1.0)


def _generator(seed: int, device, salt: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1009 + salt) % (2 ** 62))
    return gen


def _tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    # a copy a stage and pipeline: on the CPU ``as_tensor`` would share
    # one buffer between copies of a parameter (the tied ``wte``, the
    # pipelines' replicas), which the optimizer would then step twice
    return torch.tensor(np.asarray(tree), device=device)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


class MPMDGPT:
    """GPT over the MPMD pipeline runtime, with heterogeneous stages.

    ``stage_layers[p]``: pipeline ``p``'s layers a stage (summing to
    ``cfg.num_layers``; ``S * C`` virtual stages with
    ``schedule="interleaved", num_chunks=C``).  ``meshes[p][s]``: a
    stage's device (``None``: ``device``); a submesh with dp or tp raises
    ``NotImplementedError`` (item 11b).  The entries of a stage's
    parameters are keyed ``layerN`` / ``wte`` / ``wpe`` / ``ln_f`` /
    ``wte_head``, and their gradients reduce by key across pipelines
    and, for the tied ``wte``, across the first and last stage.
    ``device`` (default ``"cuda"``) holds the stages.  The parameters
    stay fp32, as the JAX model's do, and each stage computes in
    ``cfg.dtype`` (its weights cast at every forward).
    """

    def __init__(self, cfg: GPTConfig,
                 stage_layers: Sequence[Sequence[int]],
                 meshes: Optional[Sequence[Sequence[Any]]] = None,
                 schedule: str = "1f1b", num_chunks: int = 1,
                 seed: int = 0, device="cuda"):
        if cfg.num_experts > 0:
            raise NotImplementedError(
                "MPMDGPT builds no MoE blocks (num_experts > 0): the JAX "
                "package's MPMD path has no MoE blocks either (its stages "
                "hold no expert parameters); train MoE with GPTLMHeadModel "
                "or GPTPipelineModel")
        self.cfg = cfg
        self.num_chunks = int(num_chunks)
        self.stage_layers = [list(sl) for sl in stage_layers]
        P_n = len(self.stage_layers)
        S = len(self.stage_layers[0])
        if any(len(sl) != S for sl in self.stage_layers) or any(
                sum(sl) != cfg.num_layers or min(sl) < 1
                for sl in self.stage_layers):
            raise ValueError(f"stage_layers {self.stage_layers}: every "
                             f"pipeline needs {S} stages of >= 1 layer "
                             f"summing to {cfg.num_layers}")
        dev = resolve_device(device)
        if meshes is None:
            meshes = [[None] * S for _ in range(P_n)]
        self.devices = [[_check_device(m) or dev for m in row]
                        for row in meshes]
        self.device = dev

        # one draw, shared by the pipelines (dp replicas)
        rng = np.random.RandomState(seed)
        layer_params = [init_block_params(cfg, rng)
                        for _ in range(cfg.num_layers)]
        wte = rng.normal(0.0, cfg.init_std, (cfg.vocab_size,
                                             cfg.hidden_size)
                         ).astype(np.float32)
        wpe = rng.normal(0.0, cfg.init_std, (cfg.max_seq_len,
                                             cfg.hidden_size)
                         ).astype(np.float32)
        head = wte if cfg.tie_embeddings else rng.normal(
            0.0, cfg.init_std, (cfg.vocab_size, cfg.hidden_size)
        ).astype(np.float32)
        ln_f = {"g": np.ones(cfg.hidden_size, np.float32)}
        if cfg.norm == "layernorm":
            ln_f["b"] = np.zeros(cfg.hidden_size, np.float32)

        pipes: List[List[Stage]] = []
        self.layer_keys: List[List[Dict[str, Any]]] = []
        for p in range(P_n):
            stages, keys_per_stage, lo = [], [], 0
            for s, n in enumerate(self.stage_layers[p]):
                lrange = list(range(lo, lo + n))
                lo += n
                params: Dict[str, Any] = {}
                keys: Dict[str, Any] = {}
                for li in lrange:
                    params[f"layer{li}"] = layer_params[li]
                    keys[f"layer{li}"] = f"layer{li}"
                if s == 0:
                    params["wte"], keys["wte"] = wte, "wte"
                    if cfg.position == "learned":
                        params["wpe"], keys["wpe"] = wpe, "wpe"
                last = s == S - 1
                if last:
                    params["ln_f"], keys["ln_f"] = ln_f, "ln_f"
                    params["wte_head"] = head
                    keys["wte_head"] = "wte" if cfg.tie_embeddings \
                        else "head"
                d = self.devices[p][s]
                stages.append(Stage(
                    self._make_stage_fwd(lrange, s == 0, last, d),
                    _tensors(params, d), device=d, is_last=last))
                keys_per_stage.append(keys)
            pipes.append(stages)
            self.layer_keys.append(keys_per_stage)
        self.runtime = MPMDPipelineRuntime(pipes, schedule=schedule,
                                           num_chunks=num_chunks)

    def _make_stage_fwd(self, lrange: List[int], first: bool, last: bool,
                        dev: torch.device):
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)

        def body(params, x, seed):     # params in the compute dtype
            if first:
                x = _embed_apply(cfg, params, x, _generator(
                    seed, dev, 997) if cfg.dropout else None)
            for li in lrange:
                gen = _generator(seed, dev, li) if cfg.dropout else None
                x, _ = block_fn(_block_params(params[f"layer{li}"]), x,
                                cfg=cfg, gen=gen, ln_fp32=True)
            return x

        if last:
            def fwd(params, x, labels, seed):
                params = _cast(params, dt)
                return _head_loss_apply(cfg, params,
                                        body(params, x, seed), labels)
            return fwd

        def fwd(params, x, seed):
            return body(_cast(params, dt), x, seed)
        return fwd

    def register_analysis(self, *args, **kwargs):
        """The static analyzer's registry is ROADMAP queue 1 item 18."""
        raise NotImplementedError("registering stage programs with the "
                                  "static analyzer is ported in ROADMAP "
                                  "queue 1 item 18")

    # -- training ------------------------------------------------------------

    def split_micro_batches(self, ids: np.ndarray, labels: np.ndarray,
                            micro_batches: Sequence[int]
                            ) -> List[List[Tuple[Any, Any]]]:
        """The global batch apportioned into micro-batch lists a
        pipeline (Malleus' unequal counts); every micro-batch has one
        size.  The ids go to each pipeline's first stage, the labels to
        its last."""
        M_total = sum(micro_batches)
        if ids.shape[0] % M_total:
            raise ValueError(f"batch {ids.shape[0]} not divisible by "
                             f"{M_total} micro-batches")
        mb = ids.shape[0] // M_total
        data, off = [], 0
        for p, m_p in enumerate(micro_batches):
            first, last = self.devices[p][0], self.devices[p][-1]
            lst = []
            for _ in range(m_p):
                x = torch.as_tensor(np.asarray(ids[off:off + mb]),
                                    device=first)
                y = torch.as_tensor(np.asarray(labels[off:off + mb]),
                                    device=last)
                lst.append((x, y))
                off += mb
            data.append(lst)
        return data

    def train_step(self, data, seed: int = 0):
        """One step: ``(mean loss, grads[p][s], stats)``, the gradients
        summed by key across pipelines and the tied stages.  ``seed``
        seeds the step's dropout."""
        loss, grads, stats = self.runtime.train_step(data, seed=seed)
        grads = reduce_layer_grads(self.runtime, grads, self.layer_keys)
        return loss, grads, stats

    # -- state migration (elastic re-layout) ---------------------------------

    def gather_state(self, extra: Optional[List[List[Any]]] = None
                     ) -> Dict[str, Any]:
        """A host snapshot by parameter key (pipeline 0's copy; the copies
        are kept equal), as numpy.  ``extra`` gathers a structure of the
        same keys instead (the optimizer's moments)."""
        src = extra if extra is not None else \
            [[st.params for st in pipe] for pipe in self.runtime.pipes]

        def host(v):
            if isinstance(v, dict):
                return {k: host(x) for k, x in v.items()}
            # a copy also on the CPU, where ``.cpu()`` would alias
            return v.detach().to("cpu", torch.float32, copy=True).numpy()

        out: Dict[str, Any] = {}
        for s, keys in enumerate(self.layer_keys[0]):
            for name, key in keys.items():
                if key is not None and key not in out:
                    out[key] = host(src[0][s][name])
        return out

    def load_state(self, state: Dict[str, Any],
                   extra: Optional[List[List[Any]]] = None) -> None:
        """Writes a :meth:`gather_state` snapshot into every pipeline's and
        stage's copy (in place, so an optimizer keeps its references)."""
        dst = extra if extra is not None else \
            [[st.params for st in pipe] for pipe in self.runtime.pipes]

        def write(cur, val):
            if isinstance(cur, dict):
                for k in cur:
                    write(cur[k], val[k])
                return
            with torch.no_grad():
                cur.copy_(torch.as_tensor(np.asarray(val)).to(cur.device,
                                                              cur.dtype))

        for p, pipe in enumerate(self.runtime.pipes):
            for s in range(len(pipe)):
                for name, key in self.layer_keys[p][s].items():
                    if key is not None and key in state:
                        write(dst[p][s][name], state[key])


__all__ = ["MPMDGPT", "init_block_params"]
