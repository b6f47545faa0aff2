"""Where speculative and non-speculative serving part at Llama-3-8B widths.

    python3 tools/spec_divergence.py [--dtypes bfloat16,float32]
                                     [--layouts full,mla]

For each dtype and layout (random weights from seed 0, all 32 layers; the
full-head layout, or phase 11's MLA layout with ``kv_latent_dim`` 512 and
``kv_rope_dim`` 64; fp32 with TF32 off) serves ``chip_smoke.py`` phase
4's traffic three times: on a non-spec engine (the batch of phase 4), on
a non-spec engine one request at a time, and on a spec engine (a 2-layer
self-draft, k 4, as phase 20).  Prints one JSON line a dtype and layout:
the (request, first position) where the one-at-a-time tokens and the spec
tokens part from the batched non-spec tokens and, at each greedy
request's first difference of either, the three largest logits of a
dense forward over the common prefix (the port's ``generate`` path) and
how far below the largest the two tokens lie, in bf16 and in an fp32
forward of the same weights, so a flip can be told from a near tie.
Run from the repository root; needs a CUDA device (about 25 s a layout
after the build).
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


def serve(state, cfg, mix, draft, one_at_a_time=False):
    eng = cs.spec_engine(state, cfg, draft,
                         num_pages=cs.SPEC_PAGES[cfg.dtype], page_size=64,
                         max_batch=8, chunk_size=512, prefill_rows=1,
                         max_model_len=cs.SPEC_MAX_MODEL_LEN)
    prompts, late = mix
    if one_at_a_time:
        out = []
        for i, p in enumerate(prompts + [late]):
            r = cs.add_mix_request(eng, i, p, cs.SPEC_NEW_TOKENS)
            eng.run()
            out.append(r.out_tokens)
    else:
        out = [r.out_tokens for r in
               cs.serve_mix(eng, prompts, late, new=cs.SPEC_NEW_TOKENS)]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def margins(state, cfg, exact, prompts, batched, other, diffs):
    """At each greedy request's first difference in ``diffs``: the dense
    forward's top 3 and the gaps of both tokens below its largest, in the
    config's type and, where ``exact`` (the same weights in fp32 and its
    config) is given, in fp32 (TF32 off): how far the bf16 paths' own
    rounding moves the gaps."""
    out = []
    for i, j in diffs:
        if i == cs.MIX_SAMPLED:
            continue
        prefix, toks = prompts[i] + batched[i][:j], (batched[i][j],
                                                     other[i][j])
        gaps, top = cs.tie_gaps(state, cfg, prefix, toks)
        row = {"request": i, "position": j, "batched": batched[i][j],
               "other": other[i][j], "gap_batched": gaps[0],
               "gap_other": gaps[1], **top}
        if exact is not None:
            gaps, top = cs.tie_gaps(*exact, prefix, toks)
            row.update({"fp32_gap_batched": gaps[0],
                        "fp32_gap_other": gaps[1], "fp32_top": top["top"],
                        "fp32_logits": top["logits"]})
        out.append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--layouts", default="full,mla")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("spec_divergence: no CUDA device", file=sys.stderr)
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
            batched = serve(state, cfg, mix, None)
            alone = serve(state, cfg, mix, None, one_at_a_time=True)
            spec = serve(state, cfg, mix, cs.draft_state_from(
                state, cfg, cs.SPEC_DRAFT_LAYERS))
            d_alone = cs.first_differences(alone, batched)
            d_spec = cs.first_differences(spec, batched)
            exact = None
            if dtype != "float32" and (d_alone or d_spec):
                exact = ({k: v.float() for k, v in state.items()},
                         dataclasses.replace(cfg, dtype="float32"))
            print(json.dumps({
                "dtype": dtype, "layout": layout, "tf32": False,
                "one_at_a_time_vs_batched": d_alone,
                "spec_vs_batched": d_spec,
                "one_at_a_time_margins": margins(state, cfg, exact, prompts,
                                                 batched, alone, d_alone),
                "spec_margins": margins(state, cfg, exact, prompts, batched,
                                        spec, d_spec),
                "nvidia_smi": cs.smi_line(),
                "seconds": time.perf_counter() - t0}), flush=True)
            del state, exact
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
