"""The logit margins behind ``chip_smoke.py`` phase 14's serving check.

    python3 tools/token_margins.py

Serves phase 14's three prompts (the LLaMA configuration of
``__graft_entry__``, bf16, random weights from seed 0) through ``Engine``
and through ``generate``, and prints for every generated position the
engine's token, ``generate``'s, and ``generate``'s three largest logits
for that prefix (a fresh dense forward over the whole prefix), so a token
that differs can be told from a near tie.  Run from the repository root;
needs a CUDA device.
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from hetu_tpu_torch.models.generate import (  # noqa: E402
    _Params, _rotary_tables, decode_step, generate)


def main() -> int:
    if not torch.cuda.is_available():
        print("token_margins: no CUDA device", file=sys.stderr)
        return 2
    cfg = cs.graft_config("bfloat16")
    dev = torch.device("cuda")
    state = cs.random_state(cfg, seed=0, device="cuda")
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).tolist()
               for n in (100, 17, 64)]
    eng = cs.Engine(state, cfg, num_pages=64, page_size=16, max_batch=4,
                    chunk_size=64, device="cuda")
    reqs = [eng.add_request(p, 8) for p in prompts]
    eng.run()
    params = _Params(state, cfg, dev)
    for prompt, req in zip(prompts, reqs):
        want = generate(state, cfg, [prompt], 8,
                        device="cuda")[0, len(prompt):].tolist()
        rows = []
        for j in range(8):
            prefix = prompt + want[:j]
            n = len(prefix)
            caches = [tuple(torch.zeros((1, n + 1, cfg.kv_heads,
                                         cfg.head_dim), dtype=torch.bfloat16,
                                        device=dev) for _ in range(2))
                      for _ in range(cfg.num_layers)]
            cos, sin = _rotary_tables(cfg, n + 1, dev)
            logits = decode_step(cfg, params, torch.tensor(
                [prefix], dtype=torch.int32, device=dev), caches, 0, cos,
                sin)[0]
            top = torch.topk(logits, 3)
            rows.append({"j": j, "generate": want[j],
                         "engine": req.out_tokens[j],
                         "top": top.indices.tolist(),
                         "logits": top.values.tolist()})
        print(json.dumps({"prompt_len": len(prompt), "rows": rows}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
