"""Where a serving cluster's bf16 tokens part from one engine's, at
Llama-3-8B widths.

    python3 tools/cluster_divergence.py [--dtypes bfloat16]
                                        [--layouts full,mla]

For each dtype and layout (random weights from seed 0, all 32 layers;
the full-head layout, or phase 11's MLA layout; TF32 off) serves
``chip_smoke.py`` phase 4's traffic on one engine (phase 21's pool and
shapes), on one engine a request at a time, and through phase 21's
``EngineCluster`` of 1 and of 2 replicas (``policy="prefix"``).  Prints
one JSON line a dtype and layout: the (request, first position) where
each run's tokens part from the one engine's and, at each greedy
request's first difference, the three largest logits of a dense forward
over the common prefix and how far below the largest both tokens lie, in
the config's type and in an fp32 forward of the same weights (as
``tools/spec_divergence.py`` reads them).  A cluster of 1 replica
batches as the one engine does, so its tokens are the engine's exactly;
2 replicas batch otherwise.  Run from the repository root; needs a CUDA
device (about 40 s a layout after the build).
"""
import argparse
import dataclasses
import gc
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from tools.spec_divergence import margins  # noqa: E402


def one_engine(state, cfg, mix, one_at_a_time=False):
    eng = cs.Engine(state, cfg, **cs.cluster_engine_kw())
    prompts, late = mix
    if one_at_a_time:
        out = []
        for i, p in enumerate(prompts + [late]):
            r = cs.add_mix_request(eng, i, p, cs.CLUSTER_NEW)
            eng.run()
            out.append(r.out_tokens)
    else:
        out = [r.out_tokens
               for r in cs.serve_mix(eng, prompts, late, new=cs.CLUSTER_NEW)]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fleet(state, cfg, mix, replicas):
    cl = cs.EngineCluster(state, cfg, num_replicas=replicas,
                          coordinator=False, policy="prefix",
                          **cs.cluster_engine_kw())
    out = [r.out_tokens for r in cs.serve_cluster_mix(cl, *mix)]
    cl.close()
    del cl
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtypes", default="bfloat16")
    ap.add_argument("--layouts", default="full,mla")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cluster_divergence: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    rng = np.random.RandomState(0)
    mix = cs.make_mix(rng, 128256, [32, 3000, 700, 1500, 64, 2200, 400],
                      header_len=1024, tail=200)
    prompts = mix[0] + [mix[1]]
    for dtype in args.dtypes.split(","):
        for layout in args.layouts.split(","):
            t0 = time.perf_counter()
            cfg = cs.llama3_8b_config(dtype=dtype)
            if layout == "mla":
                cfg = cs.mla_config(cfg, kv_latent_dim=512, kv_rope_dim=64)
            state = cs.random_state(cfg, seed=0, device="cuda")
            base = one_engine(state, cfg, mix)
            runs = {"one_at_a_time": one_engine(state, cfg, mix, True),
                    "one_replica": fleet(state, cfg, mix, 1),
                    "two_replicas": fleet(state, cfg, mix, 2)}
            diffs = {k: cs.first_differences(v, base)
                     for k, v in runs.items()}
            exact = None
            if dtype != "float32" and any(diffs.values()):
                exact = ({k: v.float() for k, v in state.items()},
                         dataclasses.replace(cfg, dtype="float32"))
            line = {"dtype": dtype, "layout": layout, "tf32": False}
            for k, v in runs.items():
                line[k] = {"first_differences": diffs[k],
                           "tokens_differing": sum(
                               a != b for g, w in zip(v, base)
                               for a, b in zip(g, w)),
                           "margins": margins(state, cfg, exact, prompts,
                                              base, v, diffs[k])}
            line.update({"nvidia_smi": cs.smi_line(),
                         "seconds": time.perf_counter() - t0})
            print(json.dumps(line), flush=True)
            del state, exact
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
