"""The bytes a hot switch will move, from shapes alone (no card, no
process group): ``parallel.switch.SwitchPlan`` over every weight of a
training model and Adam's two moments, between two layouts.

    python3 tools/switch_bytes.py [--config llama3_8b_switch]
        [--src tp=2] [--dst dp=2] [--zero 2]

Prints one JSON line: the parameters' and the moments' moved bytes and
their sum, which a run's ``SwitchProfile.moved_bytes`` must equal
(``chip_smoke.py`` phase 25 (b) switches ``{"tp": 2}`` to ``{"dp": 2}``
under ZeRO-2).  A ZeRO level of 1 or more keeps the moments as each
parameter's dim-0 chunk over dp where the optimizer's rule takes one.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from hetu_tpu_torch.models import GPTConfig, llama3_8b_config  # noqa: E402
from hetu_tpu_torch.models.convert import param_layout  # noqa: E402
from hetu_tpu_torch.parallel.switch import Layout, SwitchPlan  # noqa: E402

CONFIGS = {"llama3_8b_switch": lambda: llama3_8b_config(num_layers=2),
           "gpt2_fp32_2_layers": lambda: GPTConfig(
               vocab_size=50304, num_layers=2, dtype="float32")}


def global_shapes(cfg):
    """Each weight's global shape under ``param_layout``'s names."""
    H, hd = cfg.hidden_size, cfg.head_dim
    qkv = (cfg.num_heads + 2 * cfg.kv_heads) * hd
    mult = 2 if cfg.activation == "swiglu" else 1
    out = {"wte.weight": (cfg.vocab_size, H), "wpe": (cfg.max_seq_len, H)}
    for i in range(cfg.num_layers):
        out.update({f"h{i}.ln_1.weight": (H,), f"h{i}.ln_1.bias": (H,),
                    f"h{i}.ln_2.weight": (H,), f"h{i}.ln_2.bias": (H,),
                    f"h{i}.attn.qkv.weight": (qkv, H),
                    f"h{i}.attn.qkv.bias": (qkv,),
                    f"h{i}.attn.out.weight": (H, cfg.num_heads * hd),
                    f"h{i}.attn.out.bias": (H,),
                    f"h{i}.mlp.up.weight": (cfg.ffn_size * mult, H),
                    f"h{i}.mlp.up.bias": (cfg.ffn_size * mult,),
                    f"h{i}.mlp.down.weight": (H, cfg.ffn_size),
                    f"h{i}.mlp.down.bias": (H,)})
    out.update({"ln_f.weight": (H,), "ln_f.bias": (H,),
                "lm_head.weight": (cfg.vocab_size, H)})
    return out


def mesh(text):
    return {k: int(v) for k, v in (p.split("=") for p in text.split(","))}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="llama3_8b_switch",
                   choices=sorted(CONFIGS))
    p.add_argument("--src", type=mesh, default=mesh("tp=2"))
    p.add_argument("--dst", type=mesh, default=mesh("dp=2"))
    p.add_argument("--zero", type=int, default=2)
    args = p.parse_args(argv)
    cfg = CONFIGS[args.config]()
    pbytes = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    shapes = global_shapes(cfg)
    units = (cfg.num_heads, cfg.kv_heads, cfg.kv_heads)

    def fix(spec, axes):
        return tuple(e if e in axes else None for e in spec)

    def layout(name, axes, spec, blocks, shape, zero):
        spec = fix(spec, axes)
        dp = axes.get("dp", 1)
        chunk = "dp" if zero and dp > 1 and (not spec or spec[0] is None) \
            and shape[0] % dp == 0 else None
        ranks = range(int(np.prod(list(axes.values()))))
        return Layout(axes, ranks, spec, blocks=blocks,
                      units=units if blocks and "qkv" in name else None,
                      chunk_axis=chunk)

    params = moments = 0
    for name, (spec, blocks) in param_layout(cfg).items():
        shape = shapes[name]
        src = (name, args.src, spec, blocks, shape)
        dst = (name, args.dst, spec, blocks, shape)
        params += SwitchPlan(shape, pbytes, layout(*src, 0),
                             layout(*dst, 0)).moved_bytes
        moments += 2 * SwitchPlan(shape, 4, layout(*src, args.zero),
                                  layout(*dst, args.zero)).moved_bytes
    print(json.dumps({"config": args.config, "src": args.src,
                      "dst": args.dst, "zero": args.zero,
                      "param_moved_bytes": params,
                      "moment_moved_bytes": moments,
                      "moved_bytes": params + moments}))


if __name__ == "__main__":
    main()
