"""Time both main paths eagerly and captured in CUDA graphs, on one card.

    python3 tools/compare_compiled_step.py [--out FILE] [--readings N]

For each workload, in turns (eager, captured, captured, eager with the
default two readings a mode), in one process:

- ``serve_full_head``: ``chip_smoke.py``'s phase 4, the serving engine at
  Llama-3-8B's widths (32 layers, random bf16 weights from seed 0; the
  8 requests of phase 4's traffic, 32 tokens each): tokens/s and TTFT
  p50 of the measured run, then ``chip_smoke.profile_steps`` (two more
  requests, unprofiled and under ``torch.profiler``): device busy and
  idle;
- ``serve_mla``: the same in the MLA layout (``kv_latent_dim`` 512,
  ``kv_rope_dim`` 64);
- ``train_gpt2_small`` and ``train_llama3_8b_4_layers``: phase 7's
  trainers (global batch 8 at seq 1024; 4 at seq 4096), ms per step (the
  mean after the first step, which captures) and peak device memory,
  then ``chip_smoke.profile_train``'s busy and idle over two more steps.

The eager readings do not hold the profiles' kernel counts to the
launches (``check=False``): the profiler has dropped a kernel record of
an eager window (767 of 768 ragged kernels seen); the captured readings
do, as ``chip_smoke.py`` does.

"Eager" runs under ``hetu_tpu_torch.core.capture.eager()``, the private
switch that runs the steps op by op on the card, as ``jax.disable_jit()``
runs a jitted function; "captured" replays the steps' CUDA graphs.  Both
run the same fixed-shape step bodies and the same kernels.  Beside every
timing: the SM clock and power draw that ``nvidia-smi`` sampled every
250 ms during it (minimum, median, maximum).  Standard output gets the
card's name and power limit, one JSON line per reading and a summary
line per workload; with ``--out FILE`` every line also goes to FILE.
Needs a CUDA device.
"""
import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from tools.smi import clocks  # noqa: E402
from hetu_tpu_torch.core import capture  # noqa: E402
from hetu_tpu_torch.models import (llama3_8b_config,  # noqa: E402
                                   mla_config)
from hetu_tpu_torch.models.convert import random_state  # noqa: E402
from hetu_tpu_torch.serving import Engine  # noqa: E402

_out = []


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    _out.append(line)


# what each reading keeps of chip_smoke's profile of its window
PROFILE_KEYS = ("device_busy_s", "unprofiled_wall_s", "wall_s",
                "idle_share", "profiled_idle_share")


def mode_ctx(mode):
    return capture.eager() if mode == "eager" else contextlib.nullcontext()


def serve_reading(cfg, state, mode):
    """Phase 4's traffic on a fresh engine: the measured run, then the
    step profile."""
    eng = Engine(state, cfg, num_pages=1024, page_size=64, max_batch=8,
                 chunk_size=512, prefill_rows=1, max_model_len=8192,
                 device="cuda")
    rng = np.random.RandomState(0)
    v = cfg.vocab_size
    mix = smoke.make_mix(rng, v, [32, 3000, 700, 1500, 64, 2200, 400],
                         header_len=1024, tail=200)
    out = {}
    with mode_ctx(mode):
        eng.add_request(rng.randint(1, v, size=16).tolist(), 2)
        eng.run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with clocks(out):
            t0 = time.perf_counter()
            reqs = smoke.serve_mix(eng, *mix)
            wall = time.perf_counter() - t0
        toks = sum(len(r.out_tokens) for r in reqs)
        ttfts = sorted(r.first_token_time - r.submit_time for r in reqs)
        out.update(tokens_per_s=toks / wall, wall_s=wall,
                   ttft_p50_s=float(np.percentile(ttfts, 50)),
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   compile_count=eng.compile_count,
                   tokens=[r.out_tokens[:4] for r in reqs])
        prof = smoke.profile_steps(eng, rng, v, check=mode == "captured")
    out.update({f"profile_{k}": prof[k] for k in PROFILE_KEYS + (
        "unified_steps", "attention_kernel_calls")})
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_reading(name, mode, steps):
    """Phase 7's trainer for ``steps`` steps: ms a step after the first,
    peak memory, then two more steps under the profiler."""
    cfg, batch, seq = smoke.train_config(name)
    g, ids, labels, model, loss, train_op = smoke.build_trainer(
        cfg, batch, seq, "cuda", lr=3e-4)
    x, y = smoke.seeded_batch(cfg.vocab_size, batch, seq, seed=0)
    feeds = {ids: x, labels: y}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, step_s, losses = {}, [], []
    with mode_ctx(mode):
        with clocks(out):
            for _ in range(steps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                l, _u = g.run(loss, [loss, train_op], feeds,
                              num_micro_batches=2)
                losses.append(float(l))
                step_s.append(time.perf_counter() - t)
        out.update(ms_per_step=1e3 * float(np.mean(step_s[1:])),
                   first_step_s=step_s[0], step_s=step_s, losses=losses,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   compile_count=g.compile_count)
        fused = smoke.fa._use_fused(
            seq, cfg.head_dim,
            torch.float32 if cfg.position == "rotary" else torch.bfloat16)
        per_step = cfg.num_layers * 2
        prof = smoke.profile_train(g, loss, train_op, feeds, {
            "flash_fwd_": per_step,
            "flash_bwd_dq_": 0 if fused else per_step,
            "flash_bwd_dkv_": per_step}, check=mode == "captured")
    out.update({f"profile_{k}": prof[k] for k in PROFILE_KEYS + (
        "steps", "flash_kernel_calls")})
    del g, ids, labels, model, loss, train_op, feeds
    gc.collect()
    torch.cuda.empty_cache()
    return out


SUMMARY_KEYS = ("tokens_per_s", "ttft_p50_s", "ms_per_step",
                "peak_memory_bytes", "profile_idle_share",
                "profile_device_busy_s", "profile_unprofiled_wall_s")


def summarize(workload, readings):
    by = {}
    for mode, r in readings:
        for k in SUMMARY_KEYS:
            if r.get(k) is not None:
                by.setdefault(k, {}).setdefault(mode, []).append(r[k])
    emit({"summary": workload, **by})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every JSON line here")
    ap.add_argument("--readings", type=int, default=2,
                    help="readings a mode and workload (default 2)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_compiled_step: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    n = args.readings
    order = ["eager"] * (n // 2) + ["captured"] * n + ["eager"] * (n - n // 2)
    for workload, cfg in (
            ("serve_full_head", llama3_8b_config()),
            ("serve_mla", mla_config(llama3_8b_config(), kv_latent_dim=512,
                                     kv_rope_dim=64))):
        state = random_state(cfg, seed=0, device="cuda")
        readings = []
        for i, mode in enumerate(order):
            r = serve_reading(cfg, state, mode)
            emit({"workload": workload, "mode": mode, "reading": i, **r})
            readings.append((mode, r))
        toks = {json.dumps(r["tokens"]) for _, r in readings}
        if len(toks) != 1:
            raise AssertionError(f"{workload}: eager and captured tokens "
                                 f"differ: {toks}")
        summarize(workload, readings)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    for workload, name, steps in (
            ("train_gpt2_small", "gpt2_small", 6),
            ("train_llama3_8b_4_layers", "llama3_8b_4_layers", 4)):
        readings = []
        for i, mode in enumerate(order):
            r = train_reading(name, mode, steps)
            emit({"workload": workload, "mode": mode, "reading": i, **r})
            readings.append((mode, r))
        if len({json.dumps(r["losses"]) for _, r in readings}) != 1:
            raise AssertionError(f"{workload}: eager and captured losses "
                                 f"differ")
        summarize(workload, readings)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(_out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
