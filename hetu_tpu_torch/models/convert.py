"""Weights into the port.

``state_from_numpy`` carries a ``hetu_tpu`` ``state_dict()`` (numpy
arrays, either naming convention) across, the MLA schema of
``mla_state_from`` included (``h{i}.attn.q``, ``attn.kv_a``,
``attn.k_up``, ``attn.v_up``); ``random_state`` draws the same names and
shapes directly on the device from a seeded ``torch.Generator``, so a
full-width model never passes through host numpy (nor, for an MLA
config, through one SVD per layer).  Both return tensors under the normalised names (``h0.attn...``).
``load_state`` writes such a dict into the training model
(``GPTLMHeadModel``) and ``state_numpy`` reads it back out.
``load_module_state`` and ``module_state_numpy`` do the same for any
module of the port under the JAX package's ``state_dict()`` names
(attribute paths, buffers such as BatchNorm's running statistics
included), unnormalised.  ``shard_state`` gives a rank of a
tensor-parallel mesh its shard of a state dict (``param_layout``: the
fused ``[q|k|v]`` and SwiGLU weights split block by block, as the
model's parameters are) and ``gather_state`` puts the shards back
together, so both packages start from one JAX state dict (an MoE
layer's experts split over ``cfg.ep_axis`` on dim 0, its gate whole).
``pipeline_state`` stacks a plain model's layers into
``GPTPipelineModel``'s ``[stages, layers, ...]`` blocks and
``plain_state`` undoes it; the JAX ``GPTPipelineModel``'s
``state_dict()`` has the port's names and loads through
``load_module_state``.
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


def _moe_shapes(cfg: GPTConfig, i: int) -> Dict[str, tuple]:
    """Layer ``i``'s MoE weights: the gate and the stacked experts (with
    their biases, as the JAX package's experts have them)."""
    E, H, f = cfg.num_experts, cfg.hidden_size, cfg.ffn_size
    pre = f"h{i}.mlp.moe"
    return {f"{pre}.gate.wg": (E, H), f"{pre}.experts.w1": (E, H, f),
            f"{pre}.experts.b1": (E, 1, f), f"{pre}.experts.w2": (E, f, H),
            f"{pre}.experts.b2": (E, 1, H)}


def state_shapes(cfg: GPTConfig) -> Dict[str, tuple]:
    """Name -> shape of every weight the serving path reads (no
    biases but the MoE experts'; norms are weight-only).  An MLA config
    has the weight-absorbed attention schema in place of the fused qkv;
    an MoE layer the gate and experts in place of the MLP."""
    H, V, L = cfg.hidden_size, cfg.vocab_size, cfg.num_layers
    hd, nh, kvh = cfg.head_dim, cfg.num_heads, cfg.kv_heads
    mult = 2 if cfg.activation == "swiglu" else 1
    shapes = {"wte.weight": (V, H), "ln_f.weight": (H,)}
    if cfg.position == "learned":
        shapes["wpe"] = (cfg.max_seq_len, H)
    for i in range(L):
        shapes[f"h{i}.ln_1.weight"] = (H,)
        shapes[f"h{i}.ln_2.weight"] = (H,)
        if cfg.is_mla:
            d_c, d_r = cfg.kv_latent_dim, cfg.rope_dim
            shapes[f"h{i}.attn.q.weight"] = (nh * (hd + d_r), H)
            shapes[f"h{i}.attn.kv_a.weight"] = (d_c + d_r, H)
            shapes[f"h{i}.attn.k_up.weight"] = (nh, hd, d_c)
            shapes[f"h{i}.attn.v_up.weight"] = (nh, hd, d_c)
        else:
            shapes[f"h{i}.attn.qkv.weight"] = ((nh + 2 * kvh) * hd, H)
        shapes[f"h{i}.attn.out.weight"] = (H, nh * hd)
        if cfg.is_moe_layer(i):
            shapes.update(_moe_shapes(cfg, i))
        else:
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
    ones for the norms, zeros for the experts' biases (their
    initializer's).  ``dtype`` defaults to the config's."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype if dtype is not None else cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    out = {}
    for name, shape in state_shapes(cfg).items():
        if len(shape) == 1:
            out[name] = torch.ones(shape, dtype=dt, device=dev)
        elif name.endswith((".b1", ".b2")):
            out[name] = torch.zeros(shape, dtype=dt, device=dev)
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


def load_module_state(model, state: Dict[str, object]) -> None:
    """Writes a ``hetu_tpu`` ``state_dict()`` (numpy arrays or tensors
    under the attribute-path names) into a port module of the same
    config: the parameters into its graph's variables (cast to their
    dtypes), the buffers in place of its own.  A missing or extra name
    raises ``KeyError``, a shape that differs ``ValueError``, before
    anything is written."""
    params = dict(model.named_parameters())
    bufs = dict(model.named_buffers())
    missing = sorted((set(params) | set(bufs)) - set(state))
    unexpected = sorted(set(state) - set(params) - set(bufs))
    if missing or unexpected:
        raise KeyError(f"missing={missing} unexpected={unexpected}")
    for name, value in state.items():
        want = params[name].shape if name in params \
            else tuple(bufs[name].shape)
        got = tuple(value.shape) if hasattr(value, "shape") \
            else np.shape(value)
        if got != tuple(want):
            raise ValueError(f"{name}: shape {got}, the module's is "
                             f"{tuple(want)}")
    for name, p in params.items():
        p.graph.reset_variable(p, state[name])
    for name in bufs:
        model._set_buffer(name, state[name])


def module_state_numpy(model) -> Dict[str, np.ndarray]:
    """A port module's parameters and buffers as numpy under the
    attribute-path names (the JAX package's ``state_dict()`` keys); bf16
    and fp16 widen to fp32."""
    out = {n: p.numpy() for n, p in model.named_parameters()}
    for n, b in model.named_buffers():
        out[n] = b.detach().float().cpu().numpy() \
            if b.is_floating_point() else b.detach().cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# a state dict's shards over a tensor-parallel mesh
# ---------------------------------------------------------------------------

def param_layout(cfg: GPTConfig, tp_axis: Optional[str] = None
                 ) -> Dict[str, tuple]:
    """Name -> (partition spec, blocks of a fused dim 0) of every weight
    of the training model (``GPTLMHeadModel``), under the normalised
    names: what its ``parallel_parameter``s declare."""
    from ..parallel.mesh import P
    tp = tp_axis or cfg.tp_axis
    H, hd = cfg.hidden_size, cfg.head_dim
    q, kv = cfg.num_heads * hd, cfg.kv_heads * hd
    bias = cfg.activation == "gelu"
    up_blocks = (cfg.ffn_size,) * 2 if cfg.activation == "swiglu" else None
    out = {"wte.weight": (P(tp, None), None)}
    if cfg.position == "learned":
        out["wpe"] = (P(), None)
    norm_keys = ("weight", "bias") if cfg.norm == "layernorm" else \
        ("weight",)
    for i in range(cfg.num_layers):
        for n in ("ln_1", "ln_2"):
            for k in norm_keys:
                out[f"h{i}.{n}.{k}"] = (P(), None)
        out[f"h{i}.attn.qkv.weight"] = (P(tp, None), (q, kv, kv))
        out[f"h{i}.attn.out.weight"] = (P(None, tp), None)
        if bias:
            out[f"h{i}.attn.qkv.bias"] = (P(tp), (q, kv, kv))
            out[f"h{i}.attn.out.bias"] = (P(), None)
        if cfg.is_moe_layer(i):
            # the experts split over ep on dim 0, the gate replicated
            espec = P(cfg.ep_axis, None, None) if cfg.ep_axis else P()
            for name in _moe_shapes(cfg, i):
                out[name] = (P() if name.endswith(".wg") else espec, None)
            continue
        out[f"h{i}.mlp.up.weight"] = (P(tp, None), up_blocks)
        out[f"h{i}.mlp.down.weight"] = (P(None, tp), None)
        if bias:
            out[f"h{i}.mlp.up.bias"] = (P(tp), up_blocks)
            out[f"h{i}.mlp.down.bias"] = (P(), None)
    for k in norm_keys:
        out[f"ln_f.{k}"] = (P(), None)
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = (P(tp, None), None)
    return out


class _Position:
    """A mesh position: the three attributes the shard helpers read."""

    def __init__(self, shape: Dict[str, int], coords: Dict[str, int]):
        self.axis_names = tuple(shape)
        self.shape, self.coords = dict(shape), dict(coords)


def shard_state(state: Dict[str, np.ndarray], cfg: GPTConfig,
                mesh_shape: Dict[str, int], coords: Dict[str, int]
                ) -> Dict[str, np.ndarray]:
    """The rank at ``coords`` of a mesh of ``mesh_shape``: its shard of a
    global state dict (either naming convention; normalised names out),
    the fused ``[q|k|v]`` and SwiGLU weights split block by block."""
    from ..parallel.mesh import take_shard
    layout = param_layout(cfg)
    pos = _Position(mesh_shape, coords)
    out = {}
    for k, v in state.items():
        name = _Params._norm(k)
        spec, blocks = layout[name]
        out[name] = take_shard(np.asarray(v), spec, pos, blocks)
    return out


def gather_state(shards: Dict[tuple, Dict[str, np.ndarray]],
                 cfg: GPTConfig, mesh_shape: Dict[str, int]
                 ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`shard_state`: the global state dict from the
    shards of every position (``{tuple(coords.items()): shard dict}``)."""
    from ..parallel.mesh import shard_pieces
    layout = param_layout(cfg)
    out: Dict[str, np.ndarray] = {}
    for key, shard in shards.items():
        pos = _Position(mesh_shape, dict(key))
        for name, piece in shard.items():
            spec, blocks = layout[name]
            if name not in out:
                gshape = [d * n for d, n in zip(
                    piece.shape, _ways(spec, mesh_shape, piece.ndim))]
                out[name] = np.zeros(gshape, piece.dtype)
            for g, loc in shard_pieces(out[name].shape, spec, pos, blocks):
                out[name][g] = piece[loc]
    return out


def _ways(spec, mesh_shape, ndim):
    from ..parallel.mesh import dim_split
    full = _Position(mesh_shape, {a: 0 for a in mesh_shape})
    return [dim_split(spec[d] if d < len(spec) else None, full)[0]
            for d in range(ndim)]


# ---------------------------------------------------------------------------
# the pipeline model's stacked blocks <-> the plain model's layers
# ---------------------------------------------------------------------------

# pipeline (``GPTPipelineModel``) block weight -> the plain model's name
# within layer i (``h{i}.<name>``)
_STACKED_NAMES = {
    "ln1": "ln_1.weight", "ln1_b": "ln_1.bias",
    "qkv": "attn.qkv.weight", "qkv_b": "attn.qkv.bias",
    "attn_out": "attn.out.weight", "attn_out_b": "attn.out.bias",
    "ln2": "ln_2.weight", "ln2_b": "ln_2.bias",
    "mlp_up": "mlp.up.weight", "mlp_up_b": "mlp.up.bias",
    "mlp_down": "mlp.down.weight", "mlp_down_b": "mlp.down.bias",
    "moe_gate": "mlp.moe.gate.wg", "moe_w1": "mlp.moe.experts.w1",
    "moe_b1": "mlp.moe.experts.b1", "moe_w2": "mlp.moe.experts.w2",
    "moe_b2": "mlp.moe.experts.b2"}
# the weights outside the blocks: pipeline name -> plain name
_OUTER_NAMES = {"wte.weight": "wte.weight", "wpe": "wpe",
                "ln_f.weight": "ln_f.weight", "ln_f.bias": "ln_f.bias",
                "lm_head": "lm_head.weight"}


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v)


def pipeline_state(state: Dict[str, object], cfg: GPTConfig,
                   num_stages: int) -> Dict[str, np.ndarray]:
    """A plain model's global state dict (``GPTLMHeadModel``, either
    naming convention) as ``GPTPipelineModel``'s of ``num_stages``
    stages: each layer's weights stacked ``[S, L/S, ...]`` under
    ``blk_<name>``.  A tied model's head is its embedding."""
    flat = {_Params._norm(k): _numpy(v) for k, v in state.items()}
    L = cfg.num_layers
    if L % num_stages:
        raise ValueError(f"{L} layers not divisible into {num_stages} "
                         f"stages")
    out = {}
    for pname, name in _OUTER_NAMES.items():
        if name in flat:
            out[pname] = flat.pop(name)
    if "lm_head" not in out:
        out["lm_head"] = out["wte.weight"].copy()
    for key, name in _STACKED_NAMES.items():
        rows = [flat.pop(f"h{i}.{name}", None) for i in range(L)]
        if all(r is None for r in rows):
            continue
        st = np.stack(rows, 0)
        out[f"blk_{key}"] = st.reshape((num_stages, L // num_stages) +
                                       st.shape[1:])
    if flat:
        raise KeyError(f"unexpected={sorted(flat)}")
    return out


def plain_state(state: Dict[str, object], cfg: GPTConfig
                ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`pipeline_state`: a ``GPTPipelineModel``
    state dict (stacked ``blk_<name>``) as ``GPTLMHeadModel``'s, under
    the normalised names (a tied config drops the head)."""
    flat = {k: _numpy(v) for k, v in state.items()}
    out = {}
    for pname, name in _OUTER_NAMES.items():
        if pname in flat:
            out[name] = flat.pop(pname)
    if cfg.tie_embeddings:
        out.pop("lm_head.weight", None)
    for key, name in _STACKED_NAMES.items():
        st = flat.pop(f"blk_{key}", None)
        if st is None:
            continue
        st = st.reshape((cfg.num_layers,) + st.shape[2:])
        for i in range(cfg.num_layers):
            out[f"h{i}.{name}"] = st[i]
    if flat:
        raise KeyError(f"unexpected={sorted(flat)}")
    return out
