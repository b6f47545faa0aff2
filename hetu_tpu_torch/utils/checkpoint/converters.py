"""Checkpoint format converters (HF GPT-2 <-> ht names, Megatron qkv order).

Numpy only: a copy of ``hetu_tpu.utils.checkpoint.converters``; the
port's GPT parameters carry the JAX package's names.

Capability parity with the reference's converters
(``python/hetu/utils/checkpoint/ht_safetensors.py:100`` qkv-ordering
converters, ``examples/gpt/gpt_hf_to_ht.py`` HF mapping): HF GPT-2 stores
linear weights as Conv1D ``[in, out]`` and fuses qkv per-head interleaved;
Megatron fuses qkv as ``[q_all; k_all; v_all]`` concatenation.  Our layers
are torch-style ``[out, in]`` with Megatron-style concatenated qkv.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def megatron_qkv_to_interleaved(w: np.ndarray, num_heads: int,
                                num_kv_heads: int = None) -> np.ndarray:
    """[q_all; k_all; v_all] rows -> per-head interleaved [q0;k0;v0;q1;...]."""
    num_kv_heads = num_kv_heads or num_heads
    assert num_heads == num_kv_heads, "interleave needs MHA (q==kv heads)"
    out = w.shape[0]
    hd = out // (3 * num_heads)
    q, k, v = np.split(w, 3, axis=0)
    qh = q.reshape(num_heads, hd, *w.shape[1:])
    kh = k.reshape(num_heads, hd, *w.shape[1:])
    vh = v.reshape(num_heads, hd, *w.shape[1:])
    inter = np.stack([qh, kh, vh], axis=1)  # [nh, 3, hd, ...]
    return inter.reshape(out, *w.shape[1:])


def interleaved_qkv_to_megatron(w: np.ndarray, num_heads: int,
                                num_kv_heads: int = None) -> np.ndarray:
    """Inverse of :func:`megatron_qkv_to_interleaved`."""
    num_kv_heads = num_kv_heads or num_heads
    assert num_heads == num_kv_heads
    out = w.shape[0]
    hd = out // (3 * num_heads)
    inter = w.reshape(num_heads, 3, hd, *w.shape[1:])
    q = inter[:, 0].reshape(num_heads * hd, *w.shape[1:])
    k = inter[:, 1].reshape(num_heads * hd, *w.shape[1:])
    v = inter[:, 2].reshape(num_heads * hd, *w.shape[1:])
    return np.concatenate([q, k, v], axis=0)


def hf_gpt2_to_ht(hf_state: Dict[str, np.ndarray],
                  tie_embeddings: bool = True) -> Dict[str, np.ndarray]:
    """Map a HuggingFace GPT-2 state dict onto the ht GPT names.

    HF Conv1D weights ``[in, out]`` are transposed to ``[out, in]``;
    ``c_attn`` is already Megatron-ordered ``[q;k;v]`` in HF GPT-2.
    """
    out: Dict[str, np.ndarray] = {}

    def _t(a):
        return np.ascontiguousarray(np.asarray(a).T)

    for key, val in hf_state.items():
        k = key[len("transformer."):] if key.startswith("transformer.") \
            else key
        v = np.asarray(val)
        if k == "wte.weight":
            out["transformer.wte.weight"] = v
        elif k == "wpe.weight":
            out["transformer.wpe"] = v
        elif k in ("ln_f.weight", "ln_f.bias"):
            out[f"transformer.{k}"] = v
        elif k == "lm_head.weight":
            out["lm_head.weight"] = v
        elif k.startswith("h."):
            parts = k.split(".")
            i, rest = parts[1], ".".join(parts[2:])
            pre = f"transformer.h.{i}"
            m = {
                "ln_1.weight": f"{pre}.ln_1.weight",
                "ln_1.bias": f"{pre}.ln_1.bias",
                "ln_2.weight": f"{pre}.ln_2.weight",
                "ln_2.bias": f"{pre}.ln_2.bias",
                "attn.c_attn.weight": f"{pre}.attn.qkv.weight",
                "attn.c_attn.bias": f"{pre}.attn.qkv.bias",
                "attn.c_proj.weight": f"{pre}.attn.out.weight",
                "attn.c_proj.bias": f"{pre}.attn.out.bias",
                "mlp.c_fc.weight": f"{pre}.mlp.up.weight",
                "mlp.c_fc.bias": f"{pre}.mlp.up.bias",
                "mlp.c_proj.weight": f"{pre}.mlp.down.weight",
                "mlp.c_proj.bias": f"{pre}.mlp.down.bias",
            }
            if rest not in m:
                continue  # attn.bias causal-mask buffers etc.
            tgt = m[rest]
            if rest.endswith("weight") and ("c_attn" in rest or
                                            "c_proj" in rest or
                                            "c_fc" in rest):
                v = _t(v)  # Conv1D [in,out] -> [out,in]
            out[tgt] = v
    if tie_embeddings and "lm_head.weight" not in out \
            and "transformer.wte.weight" in out:
        out["lm_head.weight"] = out["transformer.wte.weight"]
    return out


def ht_to_hf_gpt2(ht_state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Inverse mapping: ht GPT names -> HF GPT-2 names/layouts."""
    out: Dict[str, np.ndarray] = {}

    def _t(a):
        return np.ascontiguousarray(np.asarray(a).T)

    for key, v in ht_state.items():
        v = np.asarray(v)
        if key == "transformer.wte.weight":
            out["transformer.wte.weight"] = v
        elif key == "transformer.wpe":
            out["transformer.wpe.weight"] = v
        elif key in ("transformer.ln_f.weight", "transformer.ln_f.bias"):
            out[key] = v
        elif key == "lm_head.weight":
            out["lm_head.weight"] = v
        elif key.startswith("transformer.h."):
            parts = key.split(".")
            i, rest = parts[2], ".".join(parts[3:])
            pre = f"transformer.h.{i}"
            m = {
                "ln_1.weight": f"{pre}.ln_1.weight",
                "ln_1.bias": f"{pre}.ln_1.bias",
                "ln_2.weight": f"{pre}.ln_2.weight",
                "ln_2.bias": f"{pre}.ln_2.bias",
                "attn.qkv.weight": f"{pre}.attn.c_attn.weight",
                "attn.qkv.bias": f"{pre}.attn.c_attn.bias",
                "attn.out.weight": f"{pre}.attn.c_proj.weight",
                "attn.out.bias": f"{pre}.attn.c_proj.bias",
                "mlp.up.weight": f"{pre}.mlp.c_fc.weight",
                "mlp.up.bias": f"{pre}.mlp.c_fc.bias",
                "mlp.down.weight": f"{pre}.mlp.c_proj.weight",
                "mlp.down.bias": f"{pre}.mlp.c_proj.bias",
            }
            if rest not in m:
                continue
            if rest.endswith("weight") and rest.split(".")[0] in ("attn",
                                                                  "mlp"):
                v = _t(v)
            out[m[rest]] = v
    return out
