"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name, count and power limit;
2. build: compiles every CUDA kernel of the port from source (``nvcc``
   for sm_90a) and reports registers, shared memory and spills; the
   bf16 tensor-core flash kernels must not spill;
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
   temperature-0 tokens must equal the port's dense ``generate``;
6. flash_vs_plain: the four flash-attention kernels (forward, fused
   backward, split dq and dk/dv backward) against their plain PyTorch
   versions at the training path's shapes -- Llama-3-8B widths (b 2,
   s 4096, h 32, d 128) with the (fp32, fp32, bf16), all-fp32 and
   all-bf16 q/k/v the LLaMA path and its peers feed, GPT-2 widths (b 4,
   s 1024, h 12, d 64, bf16) -- and on small masked cases (segment-id
   tuples, causal offsets, sq != sk, fully-masked rows, s = 1000); times
   each kernel, its plain version and PyTorch's own attention
   (``scaled_dot_product_attention`` on all-bf16 and on all-fp32 inputs,
   only as a yardstick; it takes no mixed types) with CUDA events around
   the calls, host work included, and the kernels and SDPA's forward
   also around replays of a CUDA graph of one call (``device_ms``, the
   device's time alone);
7. train_main_path: ``graph("define_and_run")`` -> placeholders ->
   ``GPTLMHeadModel`` -> ``AdamOptimizer(lr=3e-4).minimize`` ->
   ``g.run(loss, [loss, train_op], feeds, num_micro_batches=2)`` for six
   steps on one seeded batch, at Llama-3-8B widths (4 layers, seq 4096,
   global batch 4) and GPT-2 small (12 layers, seq 1024, global batch 8),
   random bf16 weights; the loss must fall and each flash kernel launch
   once per layer, micro-batch and step on the backward the byte rule
   picks, the bf16 forward and dk/dv launches (GPT-2) being the
   tensor-core kernels (``train_profile`` then reads two more steps with
   ``torch.profiler``);
8. train_oracle: 2-layer fp32 models at both widths train three steps on
   the card (kernels) and on the CPU (plain versions) from the same
   weights and batches; losses and parameters must agree;
9. latent_kernel_vs_plain: the latent (MLA) ragged paged attention kernel
   against its plain version at the serving shapes of Llama-3-8B's widths
   in the MLA layout (nh 32, d_c 512, d_r 64, page 64, bf16 pages; the
   batch of phase 3), then at GPT-2 small's (nh 12, d_c 256, no rope) with
   bf16, int8 and nf4 pages written by ``quantize_rows``; times both;
10. paged_decode_vs_plain: the paged decode kernel against its plain
    version at Llama-3-8B's shapes (nh 32, kvh 8, hd 128, page 64), batch
    8 and 64, contexts 1 to 4096 with one empty request and partial last
    pages, bf16 and fp32; times both; then ``ops.paged_attention_decode``
    itself is driven for 8 decode steps of 32 layers at batch 8;
11. mla_main_path: phase 4's traffic on Llama-3-8B's widths in the MLA
    layout (``mla_config(llama3_8b_config(), 512, 64)``, all 32 layers,
    random bf16 weights from seed 0): the latent kernel 32 times per
    unified step, the full-head kernel never; then a ``step_profile``;
12. mla_quant_path: GPT-2 small's widths with ``kv_latent_dim=256`` and
    ``page_quant="int8"``, then ``"nf4"``: every request finishes, two
    fresh engines give equal tokens, 12 launches per unified step;
13. mla_oracle: 2-layer fp32 MLA models at both widths (one converted
    from a full-head state by ``mla_state_from``), where the engine's
    temperature-0 tokens must equal the port's dense ``generate``.

Then the kernel table line ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises, and the
script exits non-zero; without a CUDA device it exits non-zero before
printing any result.
"""
import gc
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import hetu_tpu_torch as ht
from hetu_tpu_torch.csrc.build import build
import hetu_tpu_torch.ops as port_ops
from hetu_tpu_torch.models import (GPTConfig, GPTLMHeadModel,
                                   llama3_8b_config, mla_config,
                                   mla_state_from)
from hetu_tpu_torch.models.convert import load_state, random_state, state_numpy
from hetu_tpu_torch.models.generate import generate
from hetu_tpu_torch.ops import flash_attention as fa
from hetu_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                paged_attention_reference)
from hetu_tpu_torch.ops.quantization import quantize_rows
from hetu_tpu_torch.ops.ragged_paged_attention import (
    latent_ragged_paged_attention_cuda,
    latent_ragged_paged_attention_reference, ragged_paged_attention_cuda,
    ragged_paged_attention_reference)
from hetu_tpu_torch.serving import Engine

H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak, H100 SXM
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores, H100 SXM
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


def graph_ms(fn, iters=10):
    """Device time of one call of ``fn``: the call is captured once in a
    CUDA graph (after warm-up calls on a side stream) and the replays are
    timed with CUDA events, which leaves out the host's work between
    launches that ``cuda_time_ms`` counts when it outlasts the kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        fn()
    ms = cuda_time_ms(g.replay, warmup=2, iters=iters)
    del g
    return ms


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
            # the mangled name: <length><kernel name> after the file's hash
            kind = re.search(r"\d((?:flash|latent_ragged|ragged|paged)"
                             r"\w*?_kernel)", head)
            entries.append({
                "kernel": kind.group(1) if kind else head[:80],
                # flash, ragged: head_dim; latent: accumulator columns per
                # lane, then the page kind; paged decode: head_dim / 32
                "template_ints": [int(x) for x in
                                  re.findall(r"Li(\d+)E", head)],
                "head_dim": int(hd.group(1)) if hd else None,
                "bf16": "nv_bfloat16" in head,
                "fused": ("Lb1E" in head) if "dkv" in head else None,
                "registers": int(regs.group(1)) if regs else None,
                "static_smem_bytes": int(smem.group(1)) if smem else 0,
                "spill_stores": int(spill.group(1)) if spill else None,
                "spill_loads": int(spill.group(2)) if spill else None})
        report[name] = {"so": info["so"], "cached": info["cached"],
                        "entries": entries}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": report})
    mma = [e for e in report["flash_attention"]["entries"]
           if "_mma_" in e["kernel"]]
    if len(mma) != 6 or any(e["spill_stores"] or e["spill_loads"]
                            for e in mma):
        raise AssertionError(f"the bf16 tensor-core flash kernels (forward "
                             f"and dk/dv, fused and split, at head dims 64 "
                             f"and 128) must build without spills: {mma}")
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


def make_mix(rng, v, lens, header_len, tail):
    """Phase 4's prompts: one per entry of ``lens``, the third a
    ``header_len``-token header (whole pages) plus ``tail`` more, and a
    late prompt that shares the header."""
    header = rng.randint(1, v, size=header_len).tolist()
    prompts = [rng.randint(1, v, size=n).tolist() for n in lens]
    prompts[2] = header + prompts[2][:tail]
    return prompts, header + rng.randint(1, v, size=77).tolist()


def serve_mix(eng, prompts, late_prompt, new=32):
    """Serves ``prompts`` (the fourth sampled), then the late prompt once
    the header's first user has finished, so that its header pages come
    from the prefix cache.  Returns the requests."""
    reqs = [eng.add_request(p, new, temperature=0.8 if i == 3 else 0.0,
                            top_p=0.95 if i == 3 else 0.0,
                            seed=7 if i == 3 else 0)
            for i, p in enumerate(prompts)]
    while reqs[2].state != "finished":
        eng.step()
    reqs.append(eng.add_request(late_prompt, new))
    eng.run()
    torch.cuda.synchronize()
    return reqs


def phase_main_path(cfg, phase, model, counter, other_counter):
    """Serves phase 4's traffic at ``cfg``; ``counter`` is the attention
    kernel this layout must launch once per layer and unified step,
    ``other_counter`` the one it must never launch."""
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
    mix = make_mix(rng, v, [32, 3000, 700, 1500, 64, 2200, 400],
                   header_len=1024, tail=200)       # 16 whole header pages
    # warm-up outside the measured run: one short request
    eng.add_request(rng.randint(1, v, size=16).tolist(), 2)
    eng.run()
    torch.cuda.synchronize()
    calls0 = eng.executable_calls
    torch.cuda.reset_peak_memory_stats()
    counter.launches = other_counter.launches = 0
    t0 = time.perf_counter()
    reqs = serve_mix(eng, *mix)
    wall = time.perf_counter() - t0
    launches = counter.launches
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
    if launches != cfg.num_layers * calls or other_counter.launches:
        raise AssertionError(
            f"kernel launches {launches} != {cfg.num_layers} x {calls} "
            f"unified steps, or the other layout's kernel ran "
            f"({other_counter.launches} launches)")
    ttfts = sorted(r.first_token_time - r.submit_time for r in reqs)
    out = {"model": model, "params": n_params, "layers": cfg.num_layers,
           "kv_bytes_per_token": eng.pool.kv_bytes_per_token,
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
    emit({"phase": phase, **out})
    emit({"phase": "step_profile", "of": phase,
          **profile_steps(eng, rng, v)})
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


# ---------------------------------------------------------------------------
# flash attention: kernels 1-4 against their plain versions (phase 6)
# ---------------------------------------------------------------------------

# (q/k dtype, v dtype) of the mixes the training path feeds: the bf16 LLaMA
# model's first layer (fp32 rotary tables promote q/k), its later layers
# (the fp32 attention output promotes the residual stream), GPT-2
FLASH_TYPES = {"fp32_qk_bf16_v": (torch.float32, torch.bfloat16),
               "fp32": (torch.float32, torch.float32),
               "bf16": (torch.bfloat16, torch.bfloat16)}
LLAMA_ATTN = (2, 4096, 32, 128)    # b (one micro-batch), s, h, d
GPT2_ATTN = (4, 1024, 12, 64)
# fp32 agreement, |got - want| <= tol * (1 + |want|): sums in another
# order over up to 4096 keys (forward), and over 4096 queries of products
# of products (backward)
FP32_FWD_TOL = 1e-4
FP32_BWD_TOL = 1e-3
# rows whose exact value cancels to 0 leave only the order of two fp32
# sums (the first causal row's dq: p = 1, dp = delta, ds = 0): they are
# held to 2**-16 of the tensor's RMS, far below one bf16 ulp.  A query row
# that sees exactly one key has dq = 0 exactly, and there the kernel's dq
# is held against 0: on an H100 the plain version's own fp32 noise in that
# row (1.04e-6 at the Llama shape in bf16) is above the floor (9.3e-7);
# phase 6 prints both
CANCEL_FLOOR = 2.0 ** -16
FLASH_REPLACES = {
    "flash_fwd": "hetu_tpu/ops/pallas/flash_attention.py:178",
    "flash_bwd_fused": "hetu_tpu/ops/pallas/flash_attention.py:325",
    "flash_bwd_dq": "hetu_tpu/ops/pallas/flash_attention.py:466",
    "flash_bwd_dkv": "hetu_tpu/ops/pallas/flash_attention.py:510"}


def flash_wrappers():
    return {"flash_fwd": fa.flash_fwd_cuda,
            "flash_bwd_fused": fa.flash_bwd_fused_cuda,
            "flash_bwd_dq": fa.flash_bwd_dq_cuda,
            "flash_bwd_dkv": fa.flash_bwd_dkv_cuda}


def flash_work(kernel, b, sq, sk, h, d, qk_dtype, v_dtype, causal=True,
               offset=0):
    """Bytes the function must move (each input read once, each output
    written once), operations over the (query, key) pairs this mask lets
    through, and the least time an H100 could take for them."""
    pairs = b * h * (sum(max(0, min(sk, i + offset + 1)) for i in range(sq))
                     if causal else sq * sk)
    qi = torch.empty((), dtype=qk_dtype).element_size()
    vi = torch.empty((), dtype=v_dtype).element_size()
    qo, kv, row = b * sq * h * d, b * sk * h * d, b * h * sq * 4

    def rate(dt):
        return H100_BF16_FLOPS if dt == torch.bfloat16 else H100_FP32_FLOPS
    # products of 2*d operations per pair: forward s = q.k (q's type) and
    # o = p.v (v's type); backward s, dp = do.v, then dq = ds.k, dv = p.do,
    # dk = ds.q, all in q's type (do and ds take q's type)
    per = {"flash_fwd": [qk_dtype, v_dtype],
           "flash_bwd_dq": [qk_dtype] * 3,
           "flash_bwd_dkv": [qk_dtype] * 4,
           "flash_bwd_fused": [qk_dtype] * 5}[kernel]
    t_ops = sum(2 * d * pairs / rate(dt) for dt in per)
    nbytes = {"flash_fwd": qo * qi * 2 + kv * (qi + vi) + row,
              "flash_bwd_dq": qo * qi * 3 + kv * (qi + vi) + 2 * row,
              "flash_bwd_dkv": qo * qi * 2 + kv * (qi + vi) * 2 + 2 * row,
              "flash_bwd_fused": qo * qi * 4 + kv * (qi + vi) * 2 + row
              }[kernel]
    t_bytes = nbytes / H100_BYTES_PER_S
    return {"bytes": nbytes, "flops": 2 * d * pairs * len(per),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def flash_inputs(b, sq, sk, h, d, types, seed):
    qk, vt = FLASH_TYPES[types]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rnd(n, dt):
        return torch.randn((b, n, h, d), generator=gen, device="cuda").to(dt)
    return rnd(sq, qk), rnd(sk, qk), rnd(sk, vt), rnd(sq, qk)


def flash_agreement(got, want, dims, scaled, tol):
    """Largest |got - want| over its limit, and the max abs error.  The
    bf16 limit (``scaled``) is BF16_REL * |want| + BF16_RMS_FLOOR * the
    RMS of want over ``dims`` (each query's row of out/dq, each key's row
    of dk/dv: a causal key's gradient grows with the number of queries
    that see it, so one (batch, head) RMS would under-cover the first
    keys): one output ulp plus the probabilities the kernel rounds to
    bf16; plus CANCEL_FLOOR * the whole tensor's RMS for rows that cancel
    to rounding noise.  Else tol * (1 + |want|)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    if scaled:
        limit = BF16_REL * w.abs() + BF16_RMS_FLOOR * \
            w.pow(2).mean(dim=dims, keepdim=True).sqrt() + \
            CANCEL_FLOOR * w.pow(2).mean().sqrt()
    else:
        limit = tol * (1 + w.abs())
    return (d / limit.clamp_min(1e-30)).max().item(), d.max().item()


def single_key_rows(b, sq, sk, causal, segs, offset, device):
    """[b, sq] bool: the query rows that see exactly one key.  Their p is
    1 on that key and out is its v, so delta = dp and dq is exactly 0."""
    split = fa._split_segments(segs, sq, sk)
    rows = torch.zeros((b, sq), dtype=torch.bool, device=device)
    for bi in range(b):
        mask = fa._visible(bi, sq, sk, causal, offset, split, device)
        if mask is not None:
            rows[bi] = mask.sum(dim=1) == 1
        elif sk == 1:
            rows[bi] = True
    return rows


def flash_ratios(q, k, v, do, causal=True, segs=None, offset=0, tag=""):
    """Runs kernels 1-4 once on these inputs and holds each output against
    the plain versions: ``({kernel: (error over limit, max abs err)},
    (plain out, lse, delta), {name: the kernels' out, lse and dq})``.
    The backward kernels get the plain forward's out/lse, so each is
    checked on its own."""
    bf16_qk, bf16_v = q.dtype == torch.bfloat16, v.dtype == torch.bfloat16
    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_fwd_cuda(q, k, v, scale, causal, segs, offset)
    torch.cuda.synchronize()
    ro, rl = fa.flash_fwd_reference(q, k, v, scale, causal, segs, offset)
    if not torch.equal(torch.isinf(lse), torch.isinf(rl)):
        raise AssertionError(f"{tag} forward: -inf rows of lse differ")
    res = {}
    live = torch.isfinite(rl)
    # the bf16 kernel rounds q * scale * log2(e) to bf16 as the reference
    # does (flash_attention.py:274), which moves lse by up to 2**-9 of the
    # scores: its lse is held at the fp32 limit against the plain version
    # on that rounded operand
    rl_q = rl if not bf16_qk else fa.flash_fwd_reference(
        (q.float() * (scale * fa.LOG2E)).to(q.dtype), k, v, 1 / fa.LOG2E,
        causal, segs, offset)[1]
    ratios = [flash_agreement(out, ro, (3,), bf16_v, FP32_FWD_TOL),
              flash_agreement(lse[live], rl_q[live], (0,), False,
                              FP32_FWD_TOL)]
    res["flash_fwd"] = (max(r[0] for r in ratios), ratios[0][1])
    want = list(fa.flash_bwd_reference(q, k, v, ro, rl, do, scale, causal,
                                       segs, offset))
    one = single_key_rows(q.shape[0], q.shape[1], k.shape[1], causal, segs,
                          offset, q.device)
    # the plain version's own distance from the exact 0 there, beside the
    # floor the gate allows such rows
    single = {"rows": int(one.sum().item()),
              "plain_dq_max_abs": want[0][one].abs().max().item()
              if one.any() else 0.0,
              "floor": CANCEL_FLOOR * want[0].float().pow(2).mean()
              .sqrt().item()}
    want[0][one] = 0
    delta = torch.einsum("bshd,bshd->bsh", do.float(), ro.float())
    got = {"flash_bwd_fused": fa.flash_bwd_fused_cuda(
        q, k, v, ro, rl, do, scale, causal, segs, offset),
        "flash_bwd_dq": (fa.flash_bwd_dq_cuda(
            q, k, v, do, rl, delta, scale, causal, segs, offset),),
        "flash_bwd_dkv": fa.flash_bwd_dkv_cuda(
            q, k, v, do, rl, delta, scale, causal, segs, offset)}
    torch.cuda.synchronize()
    picks = {"flash_bwd_fused": (0, 1, 2), "flash_bwd_dq": (0,),
             "flash_bwd_dkv": (1, 2)}
    for name, outs in got.items():
        rs = [flash_agreement(g, want[i], (3,),
                              bf16_qk or (i == 2 and bf16_v), FP32_BWD_TOL)
              for g, i in zip(outs, picks[name])]
        res[name] = (max(r[0] for r in rs), max(r[1] for r in rs))
    kernel_outs = {"out": out, "lse": lse,
                   "dq_fused": got["flash_bwd_fused"][0],
                   "dq_split": got["flash_bwd_dq"][0],
                   "single_key_rows": single}
    return res, (ro, rl, delta), kernel_outs


def check_flash(q, k, v, do, causal=True, segs=None, offset=0, tag=""):
    """:func:`flash_ratios`, raising on any kernel over its limit."""
    res, plain, kernel_outs = flash_ratios(q, k, v, do, causal, segs,
                                           offset, tag)
    for name, (ratio, err) in res.items():
        if not ratio <= 1.0:
            raise AssertionError(f"{tag} {name}: error over the limit by "
                                 f"{ratio} (max abs err {err})")
    return res, plain, kernel_outs


def library_times(b, s, h, d, types, seed=5):
    """PyTorch's own attention at this shape on ``types`` ("bf16" or
    "fp32", its default backend with TF32 off; only as a yardstick: the
    port never calls it): forward, and ``torch.autograd.grad`` through it
    for the backward.  SDPA takes no (fp32, fp32, bf16) q/k/v, so the
    mixed rows have no library time."""
    q, k, v, do = flash_inputs(b, s, s, h, d, types, seed)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
    out = sdpa(qg, kg, vg, is_causal=True)

    def fwd():
        return sdpa(qt, kt, vt, is_causal=True)

    # the backward does not capture in a graph of its own (autograd runs it
    # against the forward's stream), so it has no device time here
    return {"fwd_ms": cuda_time_ms(fwd, warmup=3, iters=20),
            "bwd_ms": cuda_time_ms(lambda: torch.autograd.grad(
                out, (qg, kg, vg), dot, retain_graph=True),
                warmup=3, iters=20),
            "fwd_device_ms": graph_ms(fwd, iters=20)}


def phase_flash():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lib = {"llama/bf16": library_times(*LLAMA_ATTN, "bf16"),
           "llama/fp32": library_times(*LLAMA_ATTN, "fp32"),
           "gpt2/bf16": library_times(*GPT2_ATTN, "bf16")}
    shapes = {}
    for shape_name, (b, s, h, d), mixes in (
            ("llama", LLAMA_ATTN, ("fp32_qk_bf16_v", "fp32", "bf16")),
            ("gpt2", GPT2_ATTN, ("bf16",))):
        for types in mixes:
            q, k, v, do = flash_inputs(b, s, s, h, d, types, seed=1)
            scale = d ** -0.5
            res, (ro, rl, delta), outs = check_flash(
                q, k, v, do, tag=f"{shape_name}/{types}")
            plain_fwd = cuda_time_ms(lambda: fa.flash_fwd_reference(
                q, k, v, scale, True), warmup=1, iters=2)
            plain_bwd = cuda_time_ms(lambda: fa.flash_bwd_reference(
                q, k, v, ro, rl, do, scale, True), warmup=1, iters=2)
            calls = {
                "flash_fwd": lambda: fa.flash_fwd_cuda(q, k, v, scale, True),
                "flash_bwd_fused": lambda: fa.flash_bwd_fused_cuda(
                    q, k, v, ro, rl, do, scale, True),
                "flash_bwd_dq": lambda: fa.flash_bwd_dq_cuda(
                    q, k, v, do, rl, delta, scale, True),
                "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_cuda(
                    q, k, v, do, rl, delta, scale, True)}
            row = {}
            yard = lib.get(f"{shape_name}/{types}")
            for name, fn in calls.items():
                work = flash_work(name, b, s, s, h, d, q.dtype, v.dtype)
                row[name] = {
                    "ms": cuda_time_ms(fn, warmup=2, iters=5),
                    "device_ms": graph_ms(fn, iters=5),
                    "plain_ms": plain_fwd if name == "flash_fwd"
                    else plain_bwd,
                    "library_ms": None if yard is None else
                    yard["fwd_ms" if name == "flash_fwd" else "bwd_ms"],
                    "max_abs_err": res[name][1],
                    "err_over_limit": res[name][0], **work}
            row["single_key_rows"] = outs["single_key_rows"]
            shapes[f"{shape_name}/{types}"] = row
            del q, k, v, do, ro, rl, delta
            torch.cuda.empty_cache()
    # small masked cases: every kernel, every type mix
    small = []
    for b, sq, sk, h, d, seg, offset in (
            (1, 64, 192, 2, 64, "tuple", 128),
            (2, 128, 128, 2, 128, "masked", 0),
            (1, 1000, 1000, 2, 128, None, 0),
            (1, 1000, 1000, 2, 64, "offset", -24)):
        for types in FLASH_TYPES:
            q, k, v, do = flash_inputs(b, sq, sk, h, d, types, seed=2)
            segs = None
            if seg in ("tuple", "masked"):
                kv = torch.arange(sk, device="cuda", dtype=torch.int32) \
                    // (sk // 2)
                kv = kv[None].expand(b, sk).contiguous()
                qi = kv[:, sk - sq:].clone()
                if seg == "masked":
                    qi[:, sq // 2:] = 7          # ids that no key has
                segs = (qi, kv)
            res, _, got = check_flash(q, k, v, do, True, segs, offset,
                                      tag=f"small {seg} {types}")
            empty = 0
            if seg == "masked" or offset < 0:
                # rows that see no key: out = 0, lse = -inf, dq = 0 exactly
                rows = slice(sq // 2, None) if seg == "masked" \
                    else slice(0, -offset)
                empty = sum(int(torch.count_nonzero(got[n][:, rows]).item())
                            for n in ("out", "dq_fused", "dq_split"))
                empty += int((got["lse"][:, :, rows] != float("-inf"))
                             .sum().item())
                if empty:
                    raise AssertionError(f"small {seg} {types}: {empty} "
                                         f"values of the empty rows are not "
                                         f"out = 0, lse = -inf, dq = 0")
            small.append({"b": b, "sq": sq, "sk": sk, "h": h, "d": d,
                          "segments": seg, "causal_offset": offset,
                          "types": types, "empty_rows_nonzero": empty,
                          "err_over_limit": {n: r[0] for n, r in res.items()}})
    emit({"phase": "flash_vs_plain", "shapes": shapes, "small_cases": small,
          "library": lib})
    return shapes


# ---------------------------------------------------------------------------
# the training step (phases 7 and 8)
# ---------------------------------------------------------------------------

def train_config(name):
    """(config, global batch, seq) of each main-path run."""
    if name == "llama3_8b_4_layers":
        # Adam at all 32 layers needs 8.03 B params x 12 B = 96 GB; depth
        # is cut to 4 (1.92 B params), widths are Meta's
        return llama3_8b_config(num_layers=4), 4, 4096
    return GPTConfig(dtype="bfloat16"), 8, 1024     # GPT-2 small, 124 M


def build_trainer(cfg, batch, seq, device, lr, seed=0):
    with ht.graph("define_and_run", create_new=True, device=device,
                  seed=seed) as g:
        ids = ht.parallel_placeholder("int32", (batch, seq), name="input_ids")
        labels = ht.parallel_placeholder("int32", (batch, seq),
                                         name="labels")
        model = GPTLMHeadModel(cfg)
        loss = model(ids, labels)
        train_op = ht.optim.AdamOptimizer(lr=lr).minimize(loss)
    return g, ids, labels, model, loss, train_op


def seeded_batch(vocab, batch, seq, seed):
    toks = np.random.RandomState(seed).randint(0, vocab, (batch, seq + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def profile_train(g, loss, train_op, feeds, steps=2):
    """Where a training step's device time goes: ``torch.profiler`` over
    ``steps`` more steps; kernel time by name and the idle share (1 -
    busy / wall, the profiler's own host cost inside the wall)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            g.run(loss, [loss, train_op], feeds, num_micro_batches=2)
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
    flash = sum(k[0] for k in kernels if "flash_" in k[1]) / 1e6
    gemm = sum(k[0] for k in kernels
               if any(t in k[1] for t in ("gemm", "nvjet", "xmma"))) / 1e6
    return {"steps": steps, "wall_s": wall, "device_busy_s": busy,
            "idle_share": (1.0 - busy / wall) if busy else None,
            "flash_attention_s": flash, "matmul_s": gemm,
            "flash_share_of_busy": flash / busy if busy else None,
            "matmul_share_of_busy": gemm / busy if busy else None,
            "top": [{"kernel": k[:90], "ms": us / 1e3, "calls": n}
                    for us, k, n in kernels[:12]]}


def phase_train(name, steps=6, micro=2):
    cfg, batch, seq = train_config(name)
    t0 = time.perf_counter()
    g, ids, labels, model, loss, train_op = build_trainer(
        cfg, batch, seq, "cuda", lr=3e-4)
    # materializes the seeded random init (a loop variable here would keep
    # the last parameter, and so the whole graph, alive after the phase)
    n_params = sum(p.get_data().numel() for p in model.parameters())
    x, y = seeded_batch(cfg.vocab_size, batch, seq, seed=0)
    feeds = {ids: x, labels: y}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    wrappers = flash_wrappers()
    for fn in wrappers.values():
        fn.launches = fn.tensor_core_launches = 0
    losses, step_s = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        l, upd = g.run(loss, [loss, train_op], feeds,
                       num_micro_batches=micro)
        losses.append(float(l))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        if upd is not None:
            raise AssertionError("the update op's fetch is not None")
    launches = {n: fn.launches for n, fn in wrappers.items()}
    tensor_core = {n: fn.tensor_core_launches for n, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: losses {losses} not finite and falling")
    # the byte rule on the first layer's k: fp32 for the LLaMA model (its
    # fp32 rotary tables promote q/k; later layers run fp32 throughout),
    # bf16 for GPT-2
    k_dtype = torch.float32 if cfg.position == "rotary" else torch.bfloat16
    fused = fa._use_fused(seq, cfg.head_dim, k_dtype)
    each = cfg.num_layers * micro * steps
    want = {"flash_fwd": each, "flash_bwd_fused": each if fused else 0,
            "flash_bwd_dq": 0 if fused else each,
            "flash_bwd_dkv": 0 if fused else each}
    if launches != want:
        raise AssertionError(f"{name}: flash launches {launches} != {want}")
    # all-bf16 attention (GPT-2) runs the tensor-core forward and dk/dv
    # kernels; the LLaMA path's fp32 and mixed attention the scalar ones
    mma = k_dtype == torch.bfloat16
    want_tc = {n: c if mma and n != "flash_bwd_dq" else 0
               for n, c in want.items()}
    if tensor_core != want_tc:
        raise AssertionError(f"{name}: tensor-core flash launches "
                             f"{tensor_core} != {want_tc}")
    steady = step_s[1:]
    out = {"config": name, "params": n_params, "layers": cfg.num_layers,
           "hidden": cfg.hidden_size, "vocab": cfg.vocab_size,
           "global_batch": batch, "seq": seq, "micro_batches": micro,
           "dtype": cfg.dtype, "setup_s": setup_s, "losses": losses,
           "step_s": step_s, "ms_per_step": 1e3 * float(np.mean(steady)),
           "tokens_per_s": batch * seq / float(np.mean(steady)),
           "peak_memory_bytes": peak, "flash_launches": launches,
           "tensor_core_launches": tensor_core,
           "backward": "fused" if fused else "split"}
    emit({"phase": "train_main_path", **out})
    emit({"phase": "train_profile", "config": name,
          **profile_train(g, loss, train_op, feeds)})
    del g, ids, labels, model, loss, train_op, feeds
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_oracle(steps=3, micro=2, lr=1e-6):
    """2-layer fp32 models train on the card (kernels) and on the CPU
    (plain versions) from the same weights and batches.  Losses within
    1e-4 relative (lr is small because one Adam step of 1e-4 on a
    full-width matrix already drives the loss on one batch from 7.7 to
    3e-4, where a relative comparison reads rounding noise).  Parameters: for every tensor the card's update agrees
    with the CPU's to 1 % (|p_card - p_cpu| <= 0.01 |p_cpu - p_init|),
    and no element differs by more than 2 * lr * steps -- Adam moves an
    element by about lr a step whatever its gradient's size, so where a
    gradient cancels to rounding noise its sign, and so that step, can
    differ between the two sums."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    for name, cfg in (
            ("llama_widths", llama3_8b_config(num_layers=2, vocab_size=1024,
                                              dtype="float32")),
            ("gpt2_widths", GPTConfig(num_layers=2, vocab_size=1024,
                                      dtype="float32"))):
        batch, seq = 2, 256
        x, y = seeded_batch(cfg.vocab_size, batch, seq, seed=1)
        runs, init = {}, None
        for dev in ("cpu", "cuda"):
            g, ids, labels, model, loss, train_op = build_trainer(
                cfg, batch, seq, dev, lr=lr, seed=1)
            if init is None:
                init = state_numpy(model)
            else:
                load_state(model, init)
            t0 = time.perf_counter()
            losses = [float(g.run(loss, [loss, train_op], {ids: x, labels: y},
                                  num_micro_batches=micro)[0])
                      for _ in range(steps)]
            runs[dev] = (losses, state_numpy(model),
                         time.perf_counter() - t0)
            del g, model
            gc.collect()
        (lc, pc, tc), (lg, pg, tg) = runs["cpu"], runs["cuda"]
        loss_rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
        upd_rel, max_abs = 0.0, 0.0
        for k in pc:
            diff = np.abs(pg[k] - pc[k])
            max_abs = max(max_abs, float(diff.max()))
            moved = float(np.linalg.norm(pc[k] - init[k]))
            if moved > 0:
                upd_rel = max(upd_rel, float(np.linalg.norm(diff)) / moved)
        ok = loss_rel <= 1e-4 and upd_rel <= 1e-2 and \
            max_abs <= 2 * lr * steps
        report[name] = {"losses_cpu": lc, "losses_card": lg,
                        "loss_rel_diff": loss_rel,
                        "param_update_rel_diff": upd_rel,
                        "param_max_abs_diff": max_abs,
                        "cpu_s": tc, "card_s": tg}
        if not ok:
            raise AssertionError(f"train oracle {name}: {report[name]}")
    emit({"phase": "train_oracle", "layers": 2, "dtype": "float32",
          "seq": 256, "steps": steps, "lr": lr, **report})
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# MLA latent serving and the paged decode op (phases 9-13)
# ---------------------------------------------------------------------------

# fp32 agreement of the latent and the paged decode kernels, |got - want| <=
# tol * (1 + |want|).  The latent q is fp32 and both sides multiply it in
# fp32 with the same dequantized page values, so only the order of up to
# 4096 fp32 sums differs, for bf16, int8 and nf4 pages alike
PAGED_FP32_TOL = 1e-4
# the engine's token layout: 8 decode slots, then one 512-token chunk slot
LATENT_Q_LENS = [1, 1, 1, 1, 1, 1, 0, 0, 512]
LATENT_CU = [0, 1, 2, 3, 4, 5, 6, 7, 8, 520]


def latent_work(q_lens, ctx_lens, ps, nh, d_c, d_r, c_bytes, r_bytes,
                quantized):
    """Bytes the function must move (the pages each live row spans, q in,
    out), operations over the causally visible (query, key) pairs, and the
    least time an H100 could take: against the fp32 peak, the arithmetic
    the reference defines, with the bf16 tensor-core figure beside it."""
    per_pos = c_bytes + d_r * r_bytes + (4 if quantized else 0)
    kv_bytes = sum(-(-c // ps) * ps * per_pos
                   for c, q in zip(ctx_lens, q_lens) if q > 0)
    live = sum(q_lens)
    qo_bytes = live * nh * ((d_c + d_r) + d_c) * 4
    pairs = sum(c - q + j + 1 for q, c in zip(q_lens, ctx_lens)
                for j in range(q))
    flops = 2 * nh * (2 * d_c + d_r) * pairs
    t_bytes = (kv_bytes + qo_bytes) / H100_BYTES_PER_S
    t_ops = flops / H100_FP32_FLOPS
    return {"bytes": kv_bytes + qo_bytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ms_at_bf16_peak":
                max(t_bytes, flops / H100_BF16_FLOPS) * 1e3}


def latent_case(name, nh, d_c, d_r, hd, ctx_lens, maxp, num_pages, kind,
                time_parts=False, check=True):
    """One latent batch at the engine's layout: kernel against plain
    version, padding tokens zero, times and bound.  ``check=False`` only
    reads the error over the limit (for kernels with planted faults)."""
    ps, max_q = 64, 512
    q_lens, cu, t = LATENT_Q_LENS, np.asarray(LATENT_CU, np.int32), 520
    rows = len(q_lens)
    dev = torch.device("cuda")
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
        return torch.randn(shape, generator=gen, device=dev)

    def i32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    q = rnd(t, nh, d_c + d_r)
    lat = rnd(num_pages, ps, 1, d_c)
    quant = None if kind == "bf16" else kind
    r_pages = scale_pages = None
    if quant:
        c_pages, scale_pages = quantize_rows(lat, quant)
    else:
        c_pages = lat.bfloat16()
        if d_r:
            r_pages = rnd(num_pages, ps, 1, d_r).bfloat16()
    kw = dict(max_q=max_q, softmax_scale=(hd + d_r) ** -0.5,
              scale_pages=scale_pages, quant=quant, latent_dim=d_c)

    def run(fn, ql):
        return fn(q, c_pages, r_pages, i32(ql), i32(cu), i32(pt),
                  i32(ctx_lens), **kw)

    got = run(latent_ragged_paged_attention_cuda, q_lens)
    torch.cuda.synchronize()
    want = run(latent_ragged_paged_attention_reference, q_lens)
    real = torch.zeros(t, dtype=torch.bool, device=dev)
    for i in range(rows):
        real[int(cu[i]):int(cu[i]) + q_lens[i]] = True
    d = (got - want).abs()
    ratio = (d / (PAGED_FP32_TOL * (1 + want.abs())))[real].max().item()
    err = d[real].max().item()
    pad_nonzero = int(torch.count_nonzero(got[~real]).item())
    if not check:
        return {"max_abs_err": err, "err_over_limit": ratio}
    if not ratio <= 1.0 or not torch.isfinite(got).all():
        raise AssertionError(f"latent kernel vs plain, {name}: error over "
                             f"the fp32 limit by {ratio} (max abs {err})")
    if pad_nonzero:
        raise AssertionError(f"{name}: {pad_nonzero} nonzero padding outputs")
    c_bytes = c_pages.shape[-1] * c_pages.element_size()
    work = latent_work(q_lens, ctx_lens, ps, nh, d_c, d_r, c_bytes, 2,
                       quant is not None)
    out = {"max_abs_err": err, "err_over_limit": ratio,
           "limit": f"|got - want| <= {PAGED_FP32_TOL} * (1 + |want|)",
           "padding_nonzero": pad_nonzero,
           "ms": cuda_time_ms(lambda: run(latent_ragged_paged_attention_cuda,
                                          q_lens), warmup=2, iters=5),
           "plain_ms": cuda_time_ms(lambda: run(
               latent_ragged_paged_attention_reference, q_lens),
               warmup=1, iters=2),
           **work, "library_ms": None,
           "shapes": {"q_lens": q_lens, "ctx_lens": ctx_lens, "nh": nh,
                      "d_c": d_c, "d_r": d_r, "ps": ps, "max_q": max_q,
                      "maxp": maxp, "pages": kind}}
    if time_parts:
        # the same batch split: its decode rows alone, its chunk alone
        out["parts"] = {}
        for part, keep in (("decode_rows", lambda i: i < 8),
                           ("chunk_row", lambda i: i == 8)):
            ql = [n if keep(i) else 0 for i, n in enumerate(q_lens)]
            pw = latent_work(ql, ctx_lens, ps, nh, d_c, d_r, c_bytes, 2,
                             quant is not None)
            out["parts"][part] = {
                "ms": cuda_time_ms(lambda: run(
                    latent_ragged_paged_attention_cuda, ql),
                    warmup=2, iters=5),
                "bound_ms": pw["bound_ms"], "bound_by": pw["bound_by"]}
    return out


# name -> (nh, d_c, d_r, head_dim, ctx_lens, maxp, num_pages, page kind)
LATENT_CASES = {"llama3_8b_mla/bf16": (
    32, 512, 64, 128, [4096, 3001, 1500, 65, 64, 1, 0, 0, 3000], 128, 1024,
    "bf16")}
LATENT_CASES.update({f"gpt2_mla/{kind}": (
    12, 256, 0, 64, [1024, 1000, 700, 65, 64, 1, 0, 0, 900], 16, 128, kind)
    for kind in ("bf16", "int8", "nf4")})


def phase_latent_kernel():
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = {}
    for name, shape in LATENT_CASES.items():
        cases[name] = latent_case(name, *shape,
                                  time_parts=name.startswith("llama"))
        torch.cuda.empty_cache()
    emit({"phase": "latent_kernel_vs_plain",
          "kernel": {"latent_ragged_paged_attention": cases}})
    return cases["llama3_8b_mla/bf16"]


def paged_work(seq_lens, nh, kvh, hd, itemsize):
    """Bytes (K and V of every cached token once, q in, out) and
    operations of a paged decode batch, and the least time for them."""
    tokens = sum(seq_lens)
    nbytes = 2 * tokens * kvh * hd * itemsize \
        + 2 * len(seq_lens) * nh * hd * itemsize
    flops = 4 * nh * hd * tokens
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_FP32_FLOPS
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def paged_inputs(batch, dtype, seed):
    """A decode batch at Llama-3-8B's shapes: contexts 1 to 4096, one
    empty request, a partial last page, trash-page table slots."""
    nh, kvh, hd, ps, maxp = 32, 8, 128, 64, 64
    rng = np.random.RandomState(seed)
    seq_lens = rng.randint(1, 4097, size=batch)
    seq_lens[:5] = [4096, 1, 0, 4001, 65]
    num_pages = 1 + int(sum(-(-c // ps) for c in seq_lens))
    perm = rng.permutation(np.arange(1, num_pages))
    pt = np.zeros((batch, maxp), np.int32)
    k = 0
    for i, c in enumerate(seq_lens):
        need = -(-int(c) // ps)
        pt[i, :need] = perm[k:k + need]
        k += need
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    args = (rnd(batch, nh, hd), rnd(num_pages, ps, kvh, hd),
            rnd(num_pages, ps, kvh, hd), torch.from_numpy(pt).cuda(),
            torch.from_numpy(seq_lens.astype(np.int32)).cuda())
    return args, [int(c) for c in seq_lens], (nh, kvh, hd)


def paged_agreement(got, want, seq_lens, dtype):
    """Largest |got - want| over its limit over the live requests (fp32:
    PAGED_FP32_TOL * (1 + |want|); bf16: the per-row bf16 limit, BF16_REL *
    |want| + BF16_RMS_FLOOR * the request's output RMS), the max abs
    error, and the number of nonzero outputs of empty requests."""
    live = torch.tensor([c > 0 for c in seq_lens], device=got.device)
    g, w = got[live].float(), want[live].float()
    d = (g - w).abs()
    if dtype == torch.bfloat16:
        limit = BF16_REL * w.abs() + BF16_RMS_FLOOR * \
            w.pow(2).mean(dim=(1, 2), keepdim=True).sqrt()
    else:
        limit = PAGED_FP32_TOL * (1 + w.abs())
    return ((d / limit.clamp_min(1e-30)).max().item(), d.max().item(),
            int(torch.count_nonzero(got[~live]).item()))


def phase_paged_decode():
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = {}
    for batch in (8, 64):
        for name, dtype in (("bf16", torch.bfloat16),
                            ("fp32", torch.float32)):
            args, seq_lens, (nh, kvh, hd) = paged_inputs(batch, dtype,
                                                         seed=batch)
            got = paged_attention_cuda(*args)
            torch.cuda.synchronize()
            want = paged_attention_reference(*args)
            ratio, err, empty = paged_agreement(got, want, seq_lens, dtype)
            if not ratio <= 1.0 or empty or not torch.isfinite(got).all():
                raise AssertionError(
                    f"paged decode kernel vs plain, batch {batch} {name}: "
                    f"over the limit by {ratio} (max abs {err}), {empty} "
                    f"nonzero outputs of the empty request")
            cases[f"batch{batch}/{name}"] = {
                "max_abs_err": err, "err_over_limit": ratio,
                "empty_request_nonzero": empty,
                "ms": cuda_time_ms(lambda: paged_attention_cuda(*args),
                                   warmup=3, iters=20),
                "plain_ms": cuda_time_ms(
                    lambda: paged_attention_reference(*args),
                    warmup=1, iters=3),
                **paged_work(seq_lens, nh, kvh, hd, args[0].element_size()),
                "library_ms": None, "seq_lens_max": max(seq_lens),
                "tokens": sum(seq_lens)}
            del args, got, want
            torch.cuda.empty_cache()
    # the op's own entry point, as a decoder would call it: 8 steps of a
    # 32-layer model at batch 8, every request one token longer each step
    (q, kp, vp, pt, sl), seq_lens, (nh, kvh, hd) = paged_inputs(
        8, torch.bfloat16, seed=1)
    sl = torch.clamp(sl, max=4000)             # room to grow within 4096
    paged_attention_cuda.launches = 0
    steps, layers = 8, 32
    for _ in range(steps):
        sl = sl + 1
        for _ in range(layers):
            out = port_ops.paged_attention_decode(q, kp, vp, pt, sl)
    torch.cuda.synchronize()
    launches = paged_attention_cuda.launches
    want = paged_attention_reference(q, kp, vp, pt, sl)
    ratio, err, _ = paged_agreement(out, want, sl.tolist(), torch.bfloat16)
    if launches != steps * layers or tuple(out.shape) != (8, nh, hd) or \
            out.dtype != torch.bfloat16 or not ratio <= 1.0 or \
            not torch.isfinite(out).all():
        raise AssertionError(
            f"paged_attention_decode entry point: {launches} launches for "
            f"{steps} x {layers} calls, shape {tuple(out.shape)}, error "
            f"over the limit by {ratio}")
    emit({"phase": "paged_decode_vs_plain",
          "limit": {"bf16": f"|got - want| <= {BF16_REL} * |want| + "
                            f"{BF16_RMS_FLOOR} * rms(want over the request)",
                    "fp32": f"|got - want| <= {PAGED_FP32_TOL} * (1 + |want|)"},
          "kernel": {"paged_attention_decode": cases},
          "entry_point": {"steps": steps, "layers": layers, "batch": 8,
                          "launches": launches, "err_over_limit": ratio}})
    return cases["batch8/bf16"], launches


def phase_mla_quant():
    """GPT-2 small's widths in the MLA layout with quantized latent pages:
    the phase-4 traffic scaled to the 1024-token position table."""
    cfg = mla_config(GPTConfig(dtype="bfloat16"), kv_latent_dim=256)
    state = random_state(cfg, seed=0, device="cuda")
    v = cfg.vocab_size
    report = {}
    for quant in ("int8", "nf4"):
        runs = []
        for _ in range(2):
            eng = Engine(state, cfg, num_pages=256, page_size=64,
                         max_batch=8, chunk_size=512, prefill_rows=1,
                         device="cuda", page_quant=quant)
            rng = np.random.RandomState(0)
            mix = make_mix(rng, v, [32, 900, 300, 500, 64, 700, 400],
                           header_len=256, tail=100)
            latent_ragged_paged_attention_cuda.launches = 0
            ragged_paged_attention_cuda.launches = 0
            t0 = time.perf_counter()
            reqs = serve_mix(eng, *mix)
            wall = time.perf_counter() - t0
            launches = latent_ragged_paged_attention_cuda.launches
            calls = eng.executable_calls
            toks = [r.out_tokens for r in reqs]
            if not all(r.state == "finished" and len(r.out_tokens) == 32
                       for r in reqs):
                raise AssertionError(f"{quant}: not every request finished "
                                     f"with 32 tokens")
            if not all(0 <= t < v for ts in toks for t in ts):
                raise AssertionError(f"{quant}: token id outside the "
                                     f"vocabulary")
            if launches != cfg.num_layers * calls or \
                    ragged_paged_attention_cuda.launches:
                raise AssertionError(
                    f"{quant}: latent launches {launches} != "
                    f"{cfg.num_layers} x {calls} unified steps")
            runs.append(toks)
            summary = eng.metrics_summary()
            ttfts = sorted(r.first_token_time - r.submit_time for r in reqs)
        if runs[0] != runs[1]:
            raise AssertionError(f"{quant}: two fresh engines disagree")
        report[quant] = {
            "requests": len(reqs), "generated_tokens": 32 * len(reqs),
            "unified_steps": calls, "kernel_launches": launches,
            "launches_per_step": launches / calls,
            "kv_bytes_per_token": eng.pool.kv_bytes_per_token,
            "page_dtype": str(eng.pool.k_pages[0].dtype),
            "prefix_cache_hits": summary["prefix_cache_hits"],
            "wall_s": wall, "tokens_per_s": 32 * len(reqs) / wall,
            "ttft_p50_s": float(np.percentile(ttfts, 50)),
            "two_engines_equal": True}
        del eng
    emit({"phase": "mla_quant_path",
          "model": "GPT-2 small widths, kv_latent_dim 256, random bf16 "
                   "weights (seed 0)", **report})
    del state
    torch.cuda.empty_cache()
    return report


def phase_mla_oracle():
    # full fp32 products on both sides
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    llama = mla_config(llama3_8b_config(num_layers=2, dtype="float32"),
                       kv_latent_dim=512, kv_rope_dim=64)
    gpt2 = GPTConfig(num_layers=2, dtype="float32")
    # the GPT-2 widths go through the converter from a full-head state
    gpt2_state, gpt2_mla = mla_state_from(
        random_state(gpt2, seed=1, device="cuda"), gpt2, kv_latent_dim=256)
    for name, cfg, state, lens in (
            ("llama3_8b_widths", llama,
             random_state(llama, seed=1, device="cuda"), (300, 17, 129)),
            ("gpt2_widths_converted", gpt2_mla, gpt2_state, (300, 17, 129))):
        rng = np.random.RandomState(1)
        prompts = [rng.randint(1, cfg.vocab_size, size=n).tolist()
                   for n in lens]
        latent_ragged_paged_attention_cuda.launches = 0
        eng = Engine(state, cfg, num_pages=64, page_size=64, max_batch=4,
                     chunk_size=128, device="cuda")
        reqs = [eng.add_request(p, 8) for p in prompts]
        eng.run()
        want = [generate(state, cfg, [p], 8, device="cuda")[0, len(p):]
                .tolist() for p in prompts]
        got = [r.out_tokens for r in reqs]
        if got != want:
            raise AssertionError(f"{name}: engine {got} != generate {want}")
        if latent_ragged_paged_attention_cuda.launches != \
                cfg.num_layers * eng.executable_calls:
            raise AssertionError(f"{name}: the latent kernel did not run "
                                 f"once per layer and step")
        report[name] = {"equal": True, "tokens": got,
                        "d_c": cfg.kv_latent_dim, "d_r": cfg.rope_dim}
        del eng, state
        torch.cuda.empty_cache()
    emit({"phase": "mla_oracle", "layers": 2, "dtype": "float32",
          "requests": 3, **report})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    dev = phase_device()
    phase_build()
    kern = phase_kernel()
    main_out = phase_main_path(
        llama3_8b_config(), "main_path",
        "Llama-3-8B widths, random bf16 weights (seed 0)",
        ragged_paged_attention_cuda, latent_ragged_paged_attention_cuda)
    phase_oracle()
    flash = phase_flash()
    train = [phase_train(name) for name in ("llama3_8b_4_layers",
                                            "gpt2_small")]
    phase_train_oracle()
    latent = phase_latent_kernel()
    paged, paged_launches = phase_paged_decode()
    mla_out = phase_main_path(
        mla_config(llama3_8b_config(), kv_latent_dim=512, kv_rope_dim=64),
        "mla_main_path",
        "Llama-3-8B widths in the MLA layout (kv_latent_dim 512, "
        "kv_rope_dim 64), random bf16 weights (seed 0)",
        latent_ragged_paged_attention_cuda, ragged_paged_attention_cuda)
    phase_mla_quant()
    phase_mla_oracle()
    rows = [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "hetu_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "hetu_tpu/ops/ragged_paged_attention.py:142",
        "launches": main_out["kernel_launches"],
        "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
        "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": None}]
    # each flash kernel at the main path's shape where it runs most: the
    # LLaMA layer-0 mix for the forward and the split backward, GPT-2 for
    # the fused backward; launches over both training runs
    where = {"flash_fwd": "llama/fp32_qk_bf16_v",
             "flash_bwd_dq": "llama/fp32_qk_bf16_v",
             "flash_bwd_dkv": "llama/fp32_qk_bf16_v",
             "flash_bwd_fused": "gpt2/bf16"}
    for name, at in where.items():
        r = flash[at][name]
        # the all-bf16 readings (the tensor-core kernels but dq's) at both
        # training shapes
        bf16 = {shape: {k: flash[f"{shape}/bf16"][name][k]
                        for k in ("ms", "device_ms", "bound_ms", "library_ms",
                                  "max_abs_err")}
                for shape in ("llama", "gpt2")}
        rows.append({
            "name": name, "route": "cuda",
            "source": "hetu_tpu_torch/csrc/flash_attention.cu",
            "replaces": FLASH_REPLACES[name], "types": at,
            "launches": sum(t["flash_launches"][name] for t in train),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "bf16": bf16})
    # the latent kernel at the MLA engine's unified-step batch, the paged
    # decode kernel at the engine's decode batch of 8 in bf16; no PyTorch
    # call attends through a page table, so no library time
    for name, source, replaces, launches, r in (
            ("latent_ragged_paged_attention",
             "hetu_tpu_torch/csrc/latent_ragged_paged_attention.cu",
             "hetu_tpu/ops/ragged_paged_attention.py:420",
             mla_out["kernel_launches"], latent),
            ("paged_attention_decode",
             "hetu_tpu_torch/csrc/paged_attention.cu",
             "hetu_tpu/ops/paged_attention.py:113", paged_launches, paged)):
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    if not all(r["launches"] > 0 for r in rows):
        raise AssertionError(f"a kernel of the path was never launched: "
                             f"{[(r['name'], r['launches']) for r in rows]}")
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
