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
   temperature-0 tokens must equal the port's dense ``generate``;
6. flash_vs_plain: the four flash-attention kernels (forward, fused
   backward, split dq and dk/dv backward) against their plain PyTorch
   versions at the training path's shapes -- Llama-3-8B widths (b 2,
   s 4096, h 32, d 128) with the (fp32, fp32, bf16), all-fp32 and
   all-bf16 q/k/v the LLaMA path and its peers feed, GPT-2 widths (b 4,
   s 1024, h 12, d 64, bf16) -- and on small masked cases (segment-id
   tuples, causal offsets, sq != sk, fully-masked rows, s = 1000); times
   each kernel, its plain version and PyTorch's own attention
   (``scaled_dot_product_attention``, only as a yardstick) with CUDA
   events;
7. train_main_path: ``graph("define_and_run")`` -> placeholders ->
   ``GPTLMHeadModel`` -> ``AdamOptimizer(lr=3e-4).minimize`` ->
   ``g.run(loss, [loss, train_op], feeds, num_micro_batches=2)`` for six
   steps on one seeded batch, at Llama-3-8B widths (4 layers, seq 4096,
   global batch 4) and GPT-2 small (12 layers, seq 1024, global batch 8),
   random bf16 weights; the loss must fall and each flash kernel launch
   once per layer, micro-batch and step on the backward the byte rule
   picks (``train_profile`` then reads two more steps with
   ``torch.profiler``);
8. train_oracle: 2-layer fp32 models at both widths train three steps on
   the card (kernels) and on the CPU (plain versions) from the same
   weights and batches; losses and parameters must agree.

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
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel, llama3_8b_config
from hetu_tpu_torch.models.convert import load_state, random_state, state_numpy
from hetu_tpu_torch.models.generate import generate
from hetu_tpu_torch.ops import flash_attention as fa
from hetu_tpu_torch.ops.ragged_paged_attention import (
    ragged_paged_attention_cuda, ragged_paged_attention_reference)
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
            kind = re.search(r"(flash_\w+?_kernel|ragged_paged_attention_"
                             r"\w+?_kernel)", head)
            entries.append({
                "kernel": kind.group(1) if kind else head[:80],
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
# held to 2**-16 of the tensor's RMS, far below one bf16 ulp
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
    ratios = [flash_agreement(out, ro, (3,), bf16_v, FP32_FWD_TOL),
              flash_agreement(lse[live], rl[live], (0,), False, FP32_FWD_TOL)]
    res["flash_fwd"] = (max(r[0] for r in ratios), ratios[0][1])
    want = fa.flash_bwd_reference(q, k, v, ro, rl, do, scale, causal, segs,
                                  offset)
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
                   "dq_split": got["flash_bwd_dq"][0]}
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


def library_times(b, s, h, d, seed=5):
    """PyTorch's own attention on all-bf16 inputs at this shape (only as
    a yardstick: the port never calls it): forward, and
    ``torch.autograd.grad`` through it for the backward."""
    q, k, v, do = flash_inputs(b, s, s, h, d, "bf16", seed)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = cuda_time_ms(lambda: sdpa(qt, kt, vt, is_causal=True),
                       warmup=3, iters=20)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
    out = sdpa(qg, kg, vg, is_causal=True)
    bwd = cuda_time_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), dot, retain_graph=True), warmup=3, iters=20)
    return {"fwd_ms": fwd, "bwd_ms": bwd}


def phase_flash():
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = {"llama": library_times(*LLAMA_ATTN),
           "gpt2": library_times(*GPT2_ATTN)}
    shapes = {}
    for shape_name, (b, s, h, d), mixes in (
            ("llama", LLAMA_ATTN, ("fp32_qk_bf16_v", "fp32", "bf16")),
            ("gpt2", GPT2_ATTN, ("bf16",))):
        for types in mixes:
            q, k, v, do = flash_inputs(b, s, s, h, d, types, seed=1)
            scale = d ** -0.5
            res, (ro, rl, delta), _ = check_flash(
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
            for name, fn in calls.items():
                work = flash_work(name, b, s, s, h, d, q.dtype, v.dtype)
                row[name] = {
                    "ms": cuda_time_ms(fn, warmup=2, iters=5),
                    "plain_ms": plain_fwd if name == "flash_fwd"
                    else plain_bwd,
                    "library_ms": lib[shape_name]["fwd_ms"]
                    if name == "flash_fwd" else lib[shape_name]["bwd_ms"],
                    "max_abs_err": res[name][1],
                    "err_over_limit": res[name][0], **work}
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
        fn.launches = 0
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
    steady = step_s[1:]
    out = {"config": name, "params": n_params, "layers": cfg.num_layers,
           "hidden": cfg.hidden_size, "vocab": cfg.vocab_size,
           "global_batch": batch, "seq": seq, "micro_batches": micro,
           "dtype": cfg.dtype, "setup_s": setup_s, "losses": losses,
           "step_s": step_s, "ms_per_step": 1e3 * float(np.mean(steady)),
           "tokens_per_s": batch * seq / float(np.mean(steady)),
           "peak_memory_bytes": peak, "flash_launches": launches,
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
    flash = phase_flash()
    train = [phase_train(name) for name in ("llama3_8b_4_layers",
                                            "gpt2_small")]
    phase_train_oracle()
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
        rows.append({
            "name": name, "route": "cuda",
            "source": "hetu_tpu_torch/csrc/flash_attention.cu",
            "replaces": FLASH_REPLACES[name],
            "launches": sum(t["flash_launches"][name] for t in train),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
