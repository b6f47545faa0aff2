"""Weights into the port.

``state_from_numpy`` carries a ``hetu_tpu`` ``state_dict()`` (numpy
arrays, either naming convention) across; ``random_state`` draws the
same names and shapes directly on the device from a seeded
``torch.Generator``, so a full-width model never passes through host
numpy.  Both return tensors under the normalised names (``h0.attn...``).
``load_state`` writes such a dict into the training model
(``GPTLMHeadModel``) and ``state_numpy`` reads it back out.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtype import torch_dtype
from .generate import _Params
from .gpt import GPTConfig


def state_from_numpy(state: Dict[str, np.ndarray], cfg: GPTConfig,
                     device="cuda", dtype=None) -> Dict[str, torch.Tensor]:
    """Numpy state dict -> port tensors on ``device``.  ``dtype`` (a
    ``torch.dtype`` or config dtype string) casts the floating tensors;
    ``None`` keeps each array's own dtype."""
    dev = resolve_device(device)
    dt = None if dtype is None else torch_dtype(dtype)
    out = {}
    for k, v in state.items():
        t = torch.from_numpy(np.array(v))           # a writable copy
        if dt is not None and t.is_floating_point():
            t = t.to(dt)
        out[_Params._norm(k)] = t.to(dev)
    return out


def state_shapes(cfg: GPTConfig) -> Dict[str, tuple]:
    """Name -> shape of every weight the serving path reads (no
    biases; norms are weight-only)."""
    H, V, L = cfg.hidden_size, cfg.vocab_size, cfg.num_layers
    hd, nh, kvh = cfg.head_dim, cfg.num_heads, cfg.kv_heads
    mult = 2 if cfg.activation == "swiglu" else 1
    shapes = {"wte.weight": (V, H), "ln_f.weight": (H,)}
    if cfg.position == "learned":
        shapes["wpe"] = (cfg.max_seq_len, H)
    for i in range(L):
        shapes[f"h{i}.ln_1.weight"] = (H,)
        shapes[f"h{i}.ln_2.weight"] = (H,)
        shapes[f"h{i}.attn.qkv.weight"] = ((nh + 2 * kvh) * hd, H)
        shapes[f"h{i}.attn.out.weight"] = (H, nh * hd)
        shapes[f"h{i}.mlp.up.weight"] = (cfg.ffn_size * mult, H)
        shapes[f"h{i}.mlp.down.weight"] = (H, cfg.ffn_size)
    if not cfg.tie_embeddings:
        shapes["lm_head.weight"] = (V, H)
    return shapes


@torch.no_grad()
def random_state(cfg: GPTConfig, seed: int = 0, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 std: float = 0.02) -> Dict[str, torch.Tensor]:
    """Random weights drawn on ``device``: normal(0, ``std``) matrices,
    ones for the norms, no biases.  ``dtype`` defaults to the config's."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype if dtype is not None else cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    out = {}
    for name, shape in state_shapes(cfg).items():
        if len(shape) == 1:
            out[name] = torch.ones(shape, dtype=dt, device=dev)
        else:
            out[name] = torch.randn(shape, generator=gen, dtype=dt,
                                    device=dev).mul_(std)
    return out


def load_state(model, state: Dict[str, object]) -> None:
    """Writes a state dict (numpy arrays or tensors, either naming
    convention, e.g. a JAX ``model.state_dict()``) into the training
    model's variables, cast to each parameter's dtype.  Every parameter
    must be given and every entry used; otherwise ``KeyError``."""
    params = {_Params._norm(n): p for n, p in model.named_parameters()}
    given = {_Params._norm(k): v for k, v in state.items()}
    missing = sorted(set(params) - set(given))
    unexpected = sorted(set(given) - set(params))
    if missing or unexpected:
        raise KeyError(f"missing={missing} unexpected={unexpected}")
    for name, p in params.items():
        p.graph.reset_variable(p, given[name])


def state_numpy(model) -> Dict[str, np.ndarray]:
    """The training model's weights as numpy under the normalised names
    (``h0.attn.qkv.weight``); bf16 and fp16 widen to fp32.  The dict
    feeds ``state_from_numpy`` and so the serving ``Engine`` and
    ``generate``."""
    return {_Params._norm(n): p.numpy() for n, p in model.named_parameters()}
