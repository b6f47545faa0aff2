"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name, count and power limit;
2. build: compiles every CUDA kernel of the port from source (``nvcc``
   for sm_90a) and reports registers, shared memory and spills;
3. kernel_vs_plain: the ragged paged attention kernel against its plain
   PyTorch version at the serving shapes of Llama-3-8B (nh 32, kvh 8,
   hd 128, page 64, bf16): a 512-token prefill chunk over a context of
   many pages, decode rows up to 4096 tokens of context, padding rows, a
   partial last page and trash-page table slots; times both with CUDA
   events;
4. main_path: the serving ``Engine`` at Llama-3-8B widths (all 32
   layers, random bf16 weights from seed 0) serves 8 requests, one of
   them sampled and two sharing a 1024-token header through the prefix
   cache, and must launch the kernel 32 times per unified step;
   ``step_profile`` then reads where a step's device time goes
   (``torch.profiler`` over two more requests);
5. oracle: a 2-layer fp32 model at the same widths, where the engine's
   temperature-0 tokens must equal the port's dense ``generate``.

Then the kernel table line ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises, and the
script exits non-zero; without a CUDA device it exits non-zero before
printing any result.
"""
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from hetu_tpu_torch.csrc.build import build
from hetu_tpu_torch.models import llama3_8b_config
from hetu_tpu_torch.models.convert import random_state
from hetu_tpu_torch.models.generate import generate
from hetu_tpu_torch.ops.ragged_paged_attention import (
    ragged_paged_attention_cuda, ragged_paged_attention_reference)
from hetu_tpu_torch.serving import Engine

H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12   # HBM3 bandwidth, H100 SXM
# bf16 agreement, element by element within each row of the batch:
# |got - want| <= 2**-7 * |want| + rms(want over the row) / 32.  Both
# sides round their fp32 results to bf16, which differ by at most one
# ulp, at most 2**-7 of the value; the kernel also rounds its
# probabilities to bf16 before the second product, an error of about
# 0.2 % of the row's output RMS (about 1 % at its largest), well inside
# the floor.  The limit scales with each row's outputs, which shrink as
# 1 / sqrt(context): a fixed absolute limit would be as large as the
# outputs of the long rows.
BF16_REL = 2.0 ** -7
BF16_RMS_FLOOR = 1.0 / 32


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, warmup=2, iters=10):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = {"name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda}
    emit({"phase": "device", **dev})
    return dev


def phase_build():
    t0 = time.perf_counter()
    built = build()
    report = {}
    for name, info in built.items():
        entries = []
        for block in info["ptxas"].split("Compiling entry function")[1:]:
            head = block.splitlines()[0]
            hd = re.search(r"Li(\d+)E", head)
            regs = re.search(r"Used (\d+) registers", block)
            smem = re.search(r"(\d+) bytes smem", block)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", block)
            entries.append({
                "kernel": ("mma_bf16" if "_mma_kernel" in head
                           else "scalar_f32"),
                "head_dim": int(hd.group(1)) if hd else None,
                "registers": int(regs.group(1)) if regs else None,
                "static_smem_bytes": int(smem.group(1)) if smem else 0,
                "spill_stores": int(spill.group(1)) if spill else None,
                "spill_loads": int(spill.group(2)) if spill else None})
        report[name] = {"so": info["so"], "cached": info["cached"],
                        "entries": entries}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": report})
    return report


def ragged_work(q_lens, ctx_lens, maxp, nh, kvh, hd, itemsize):
    """Bytes the function must move and operations it must do for these
    rows, and the least time an H100 could take for them."""
    s = len(q_lens)
    kv_bytes = sum(c * kvh * hd * 2 * itemsize for c, q in
                   zip(ctx_lens, q_lens) if q > 0)
    qo_bytes = 2 * sum(q_lens) * nh * hd * itemsize
    meta = (s + (s + 1) + s * maxp + s) * 4
    flops = 4 * nh * hd * sum(c - q + j + 1 for q, c in zip(q_lens, ctx_lens)
                              for j in range(q))
    t_bytes = (kv_bytes + qo_bytes + meta) / H100_BYTES_PER_S
    t_ops = flops / H100_BF16_FLOPS
    return {"bytes": kv_bytes + qo_bytes + meta, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bf16_agreement(got, want, cu, q_lens):
    """Each row's largest |got - want| over its limit (BF16_REL * |want|
    + BF16_RMS_FLOOR * the row's output RMS), and the max abs error over
    every real token."""
    ratios, err = [], 0.0
    for i, n in enumerate(q_lens):
        if n == 0:
            continue
        g = got[int(cu[i]):int(cu[i]) + n].float()
        w = want[int(cu[i]):int(cu[i]) + n].float()
        d = (g - w).abs()
        limit = BF16_REL * w.abs() + BF16_RMS_FLOOR * w.pow(2).mean().sqrt()
        ratios.append((d / limit.clamp_min(1e-30)).max().item())
        err = max(err, d.max().item())
    return ratios, err


def phase_kernel():
    nh, kvh, hd, ps, max_q, maxp = 32, 8, 128, 64, 512, 128
    dev = torch.device("cuda")
    # the engine's layout: 8 decode slots, then one 512-token chunk slot
    q_lens = [1, 1, 1, 1, 1, 1, 0, 0, 512]
    ctx_lens = [4096, 3001, 1500, 65, 64, 1, 0, 0, 3000]
    rows = len(q_lens)
    cu = np.asarray([0, 1, 2, 3, 4, 5, 6, 7, 8, 520], np.int32)
    t = 520
    num_pages = 1024
    rng = np.random.RandomState(0)
    perm = rng.permutation(np.arange(1, num_pages))
    pt = np.zeros((rows, maxp), np.int32)        # trash-page padding
    k = 0
    for i, c in enumerate(ctx_lens):
        need = -(-c // ps)
        pt[i, :need] = perm[k:k + need]
        k += need
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    q = rnd(t, nh, hd)
    kp, vp = rnd(num_pages, ps, kvh, hd), rnd(num_pages, ps, kvh, hd)

    def i32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    args = (q, kp, vp, i32(q_lens), i32(cu), i32(pt), i32(ctx_lens))
    got = ragged_paged_attention_cuda(*args, max_q=max_q)
    torch.cuda.synchronize()
    want = ragged_paged_attention_reference(*args, max_q=max_q)
    real = torch.zeros(t, dtype=torch.bool, device=dev)
    for i in range(rows):
        real[int(cu[i]):int(cu[i]) + q_lens[i]] = True
    ratios, err = bf16_agreement(got, want, cu, q_lens)
    pad_nonzero = int(torch.count_nonzero(got[~real]).item())
    if not max(ratios) <= 1.0:
        raise AssertionError(
            f"kernel vs plain: error over the bf16 limit by {max(ratios)} "
            f"(per live row {ratios}); max abs err {err}")
    if pad_nonzero:
        raise AssertionError(f"{pad_nonzero} nonzero padding outputs")
    ms = cuda_time_ms(lambda: ragged_paged_attention_cuda(*args,
                                                          max_q=max_q),
                      warmup=3, iters=20)
    plain_ms = cuda_time_ms(lambda: ragged_paged_attention_reference(
        *args, max_q=max_q), warmup=1, iters=3)
    work = ragged_work(q_lens, ctx_lens, maxp, nh, kvh, hd, 2)
    # the same batch split: its decode rows alone, its chunk alone
    parts = {}
    for part, keep in (("decode_rows", lambda i: i < 8),
                       ("chunk_row", lambda i: i == 8)):
        ql = [q if keep(i) else 0 for i, q in enumerate(q_lens)]
        pargs = (q, kp, vp, i32(ql)) + args[4:]
        pw = ragged_work(ql, ctx_lens, maxp, nh, kvh, hd, 2)
        parts[part] = {
            "ms": cuda_time_ms(lambda: ragged_paged_attention_cuda(
                *pargs, max_q=max_q), warmup=3, iters=20),
            "bound_ms": pw["bound_ms"], "bound_by": pw["bound_by"]}
    out = {"max_abs_err": err,
           "limit": f"|got - want| <= {BF16_REL} * |want| + "
                    f"{BF16_RMS_FLOOR} * rms(want over the row)",
           "err_over_limit_by_row": ratios, "parts": parts,
           "padding_nonzero": pad_nonzero, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
           "bytes": work["bytes"], "flops": work["flops"],
           "library_ms": None,
           "shapes": {"q_lens": q_lens, "ctx_lens": ctx_lens,
                      "nh": nh, "kvh": kvh, "hd": hd, "ps": ps,
                      "max_q": max_q, "maxp": maxp, "dtype": "bfloat16"}}
    emit({"phase": "kernel_vs_plain",
          "kernel": {"ragged_paged_attention": out}})
    return out


def profile_steps(eng, rng, v):
    """Where a serving step's device time goes: ``torch.profiler`` over
    the steps that serve two more requests (a 1000-token prompt in two
    chunks beside a decoding one), after the measured run.  Sums the
    CUDA kernels' own times by name; the idle share is 1 - busy / wall,
    with the profiler's own host cost inside the wall time."""
    eng.add_request(rng.randint(1, v, size=100).tolist(), 24)
    eng.add_request(rng.randint(1, v, size=1000).tolist(), 8)
    steps = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        while eng.has_work:
            eng.step()
            steps += 1
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us, e.key, e.count))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels) / 1e6
    attn = sum(k[0] for k in kernels
               if "ragged_paged_attention" in k[1]) / 1e6
    return {"steps": steps, "wall_s": wall, "device_busy_s": busy,
            "idle_share": (1.0 - busy / wall) if busy else None,
            "attention_s": attn,
            "attention_share_of_busy": attn / busy if busy else None,
            "top": [{"kernel": k[:90], "ms": us / 1e3, "calls": n}
                    for us, k, n in kernels[:8]]}


def phase_main_path():
    cfg = llama3_8b_config()
    t0 = time.perf_counter()
    state = random_state(cfg, seed=0, device="cuda")
    n_params = sum(v.numel() for v in state.values())
    eng = Engine(state, cfg, num_pages=1024, page_size=64, max_batch=8,
                 chunk_size=512, prefill_rows=1, max_model_len=8192,
                 device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    v = cfg.vocab_size
    header = rng.randint(1, v, size=1024).tolist()   # 16 whole pages
    lens = [32, 3000, 700, 1500, 64, 2200, 400]
    prompts = [rng.randint(1, v, size=n).tolist() for n in lens]
    prompts[2] = header + prompts[2][:200]
    late_prompt = header + rng.randint(1, v, size=77).tolist()
    # warm-up outside the measured run: one short request
    eng.add_request(rng.randint(1, v, size=16).tolist(), 2)
    eng.run()
    torch.cuda.synchronize()
    calls0 = eng.executable_calls
    torch.cuda.reset_peak_memory_stats()
    ragged_paged_attention_cuda.launches = 0
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, 32, temperature=0.8 if i == 3 else 0.0,
                            top_p=0.95 if i == 3 else 0.0,
                            seed=7 if i == 3 else 0)
            for i, p in enumerate(prompts)]
    # the header's second user arrives once the first has finished, so
    # its 16 header pages come from the prefix cache
    while reqs[2].state != "finished":
        eng.step()
    reqs.append(eng.add_request(late_prompt, 32))
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ragged_paged_attention_cuda.launches
    calls = eng.executable_calls - calls0
    summary = eng.metrics_summary()
    if not all(r.state == "finished" and len(r.out_tokens) == 32
               for r in reqs):
        raise AssertionError("not every request finished with 32 tokens")
    toks = [t for r in reqs for t in r.out_tokens]
    if not all(0 <= t < v for t in toks):
        raise AssertionError("token id outside the vocabulary")
    if summary["prefix_cache_hits"] < 1:
        raise AssertionError("the shared header missed the prefix cache")
    if launches != cfg.num_layers * calls:
        raise AssertionError(f"kernel launches {launches} != "
                             f"{cfg.num_layers} x {calls} unified steps")
    ttfts = sorted(r.first_token_time - r.submit_time for r in reqs)
    out = {"model": "Llama-3-8B widths, random bf16 weights (seed 0)",
           "params": n_params, "layers": cfg.num_layers,
           "setup_s": setup_s, "requests": len(reqs),
           "prompt_tokens": [len(r.prompt) for r in reqs],
           "generated_tokens": len(toks), "wall_s": wall,
           "tokens_per_s": len(toks) / wall,
           "ttft_p50_s": float(np.percentile(ttfts, 50)),
           "unified_steps": calls, "kernel_launches": launches,
           "prefix_cache_hits": summary["prefix_cache_hits"],
           "prefix_cache_tokens_saved":
               summary["prefix_cache_tokens_saved"],
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "sampled_tokens": reqs[3].out_tokens[:8]}
    emit({"phase": "main_path", **out})
    emit({"phase": "step_profile", **profile_steps(eng, rng, v)})
    del eng, state
    torch.cuda.empty_cache()
    return out


def phase_oracle():
    # full fp32 products on both sides
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama3_8b_config(num_layers=2, dtype="float32")
    state = random_state(cfg, seed=1, device="cuda")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).tolist()
               for n in (300, 17, 129)]
    eng = Engine(state, cfg, num_pages=64, page_size=64, max_batch=4,
                 chunk_size=128, device="cuda")
    reqs = [eng.add_request(p, 8) for p in prompts]
    eng.run()
    want = [generate(state, cfg, [p], 8, device="cuda")[0, len(p):]
            .tolist() for p in prompts]
    got = [r.out_tokens for r in reqs]
    if got != want:
        raise AssertionError(f"engine {got} != generate {want}")
    emit({"phase": "oracle", "layers": 2, "dtype": "float32",
          "requests": len(prompts), "equal": True, "tokens": got})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    dev = phase_device()
    phase_build()
    kern = phase_kernel()
    main_out = phase_main_path()
    phase_oracle()
    emit({"kernels": [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "hetu_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "hetu_tpu/ops/ragged_paged_attention.py:142",
        "launches": main_out["kernel_launches"],
        "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
        "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
