"""Planted faults in the flash-attention kernels, in the latent ragged
paged attention kernel and in the split-KV decode core, against the gates
of ``chip_smoke.py``'s phases 6, 9, 3 and 10.

    python -m hetu_tpu_torch.csrc.planted_faults [flash] [latent] [core]
        (on the card, from the repository root; every group by default)

Each fault is a text replacement in a copy of a kernel's source written
under ``csrc/_build/`` (the checkout's own sources stay as they are),
built with the flags of ``build.py`` and loaded in place of the real
library; the kernels then run at the main paths' shapes and
``chip_smoke.flash_ratios`` / ``chip_smoke.latent_case`` read each
kernel's error over its limit.  A gate that works reads above 1 for the
kernels (or page kinds) a fault touches.  The flash faults:

- ``q_tile``: the 3xTF32 dk/dv template's q loop stops one tile early for
  KV tiles at or past key 2048 (the split dk/dv and the fused backward in
  the fp32 and mixed types);
- ``mask_fwd_mma`` and ``mask_fwd_tf32``: the causal mask of the
  tensor-core forward shifted by one (a query also sees the next key), in
  its bf16 mma.sync instantiations (head dims 32 and 256, read at d 256),
  or in its fp32 and mixed (3xTF32) ones;
- ``mask_dq_mma`` and ``mask_dq_tf32``: the same in the tensor-core dq
  kernel, in its bf16 mma.sync instantiations (head dims 32 and 256, read
  at d 256), or in its fp32 and mixed (3xTF32) ones;
- ``mask_dkv_mma`` and ``mask_dkv_tf32``: the same in the tensor-core
  dk/dv template (split and fused), in its bf16 mma.sync instantiations
  (read at d 256), or in its fp32 and mixed (3xTF32) ones;
- ``prefetch``: the mma.sync forward's cp.async double buffer skips the
  copy of the last KV tile for q tiles at or past row 2048, so that tile
  is read from the buffer of two tiles before (the fp32 and mixed types at
  the Llama shape);
- ``tf32_1term_dkv``: the 3xTF32 dk/dv template's products cut to their
  hi.hi term (one-term TF32; v.dO of bf16 v to v.dO_hi), in the split
  dk/dv and the fused backward of the fp32 and mixed types.  Besides
  phase 6's gates, phase 8's training oracle at GPT-2 widths (its fused
  fp32 backward) must refuse it.

The faults of the wgmma kernels (the bf16 forward, dq and dk/dv template
at head dims 64 and 128), against phase 6's bf16 gates at the Llama and
GPT-2 shapes:

- ``swizzle_wgmma``: TMA writes the tiles unswizzled while every wgmma
  descriptor reads them in the 128-byte swizzle (``wgmma_bf16.cuh``; the
  two layouts differ only inside each 1024-byte atom, so every read stays
  in its tile: a descriptor naming a narrower swizzle would read past
  shared memory instead);
- ``stale_stage``: the producer completes a stage's "full" barrier without
  loading it for K/V tiles (forward, dq) or q tiles (dk/dv) at or past 2048,
  so the consumers read what the stage held kStages tiles before; a
  consumer that skipped its wait would read a stage whose load may or may
  not have landed, a race no gate can be held to, so the fault makes the
  staleness certain (and cannot hang: every barrier still completes);
- ``transpose_v``, ``transpose_do`` and ``transpose_k``: the transpose bit
  dropped on V in the forward's P V, on dO in the dk/dv template's P^T dO,
  or on K in dq's dS K, for the first k-step of a tile (whose operand, read
  K-major, still lies inside the tile; later k-steps would read past it);
- ``mask_fwd_wgmma``, ``mask_dq_wgmma`` and ``mask_dkv_wgmma``: the causal
  mask skipped on the tiles (dq: the 64-key chunks) that cross the
  diagonal.

The latent faults, against phase 9's gate on each of its batches.  In
the mma.sync route (int8 and nf4 pages in phase 9):

- ``nf4_nibbles``: the two 4-bit codes of a byte swapped when the latent
  kernel dequantizes packed pages (touches the nf4 pages only);
- ``last_page``: the last page of a decode row whose context is longer
  than 512 tokens dropped (touches the int8 and nf4 batches, whose decode
  rows reach 1024 tokens);
- ``tf32_1term_latent``: every latent product (Q K^T and P V, every page
  kind) cut to its hi.hi term, one-term TF32 (touches int8 and nf4).

In the wgmma route (the bf16 batches at Llama-3-8B and GPT-2 MLA widths):

- ``bf16_1term_latent``: the lo term of q and of p dropped (one bf16
  term, ``bf16_terms``);
- ``mask_latent_wgmma``: the causal mask skipped on the chunk row's
  diagonal tiles (a query sees the keys after it up to its item's last
  query); touches the GPT-2-width batch only: at nh 32 an item of 32
  pairs is one query, whose KV range already ends at its diagonal;
In the merge kernel that both routes share:

- ``merge_latent``: the merge of a split decode row drops its last live
  KV slice (touches every batch: each splits its decode rows).

The decode-core faults, in ``paged_decode.cuh``, which the ragged kernel's
decode rows and the paged decode kernel share (each mutant header is
inlined into copies of both sources); phase 3's gate (the serving batch)
and phase 10's (batches 8 and 64, bf16 and fp32) must both refuse each:

- ``split_merge``: the merge of a split item drops its last live slice;
- ``kv_ring``: the ring's copies are skipped for tiles at or past position
  2048, so those stages are read without their copy ever landing (they
  hold the tile of four tiles before, or whatever shared memory held: a
  NaN output reads as an infinite error);
- ``decode_group``: the last query head of a group is scored with its
  neighbour's query row (the group's head mapping off by one), so its
  output attends with the wrong head.

Prints one JSON line per fault and shape; exits non-zero if a gate
misses a fault.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

from . import build


def _within(src: str, start: str, end: str, old: str, new: str) -> str:
    """``src`` with the first ``old`` between ``start`` and ``end``
    replaced; raises if it is not there."""
    i = src.index(start)
    j = src.index(end, i)
    k = src.index(old, i)
    if k >= j:
        raise ValueError(f"{old!r} not found in {start!r}")
    return src[:k] + new + src[k + len(old):]


def _mutants(src: str):
    fwd = ("flash_fwd_mma_kernel(const TQ*", "dq_mma_smem_bytes")
    dq = ("flash_bwd_dq_mma_kernel(const TQ*", "dkv_mma_smem_bytes")
    dkv_mma = ("flash_bwd_dkv_mma_kernel(const bf16*",
               "flash_bwd_dkv_tf32_kernel(const float*")
    dkv_tf32 = ("flash_bwd_dkv_tf32_kernel(const float*", "// wgmma kernels:")
    fwd_wg = ("flash_fwd_wgmma_kernel(const __grid_constant__",
              "struct DkvWgmma")
    dkv_wg = ("flash_bwd_dkv_wgmma_kernel(const __grid_constant__",
              "struct DqWgmma")
    dq_wg = ("flash_bwd_dq_wgmma_kernel(const __grid_constant__",
             "// launchers")
    fwd_mask = "if (causal) ok = ok && j <= row + offset;"
    dq_mask = "if (causal) ok = ok && j <= wrow0 + gq + 8 * (i >> 1) + offset;"
    out = {
        "q_tile": _within(src, *dkv_tf32, "it < n_q; ++it)",
                          "it < n_q - (k0 >= 2048); ++it)"),
        "mask_dkv_mma": _within(src, *dkv_mma, "key <= qi + offset",
                                "key <= qi + offset + 1"),
        "mask_dkv_tf32": _within(src, *dkv_tf32, "key <= qi + offset",
                                 "key <= qi + offset + 1"),
        "prefetch": _within(src, *fwd, "if (t + 1 < n_kv) {",
                            "if (t + 1 < n_kv - (q0 >= 2048)) {")}
    for kernel, where, old in (("fwd", fwd, fwd_mask), ("dq", dq, dq_mask)):
        for route, on in (("mma", "kBf16"), ("tf32", "!kBf16")):
            out[f"mask_{kernel}_{route}"] = _within(
                src, *where, old, old.replace("+ offset;",
                                              f"+ offset + {on};"))
    out["tf32_1term_dkv"] = _one_term(src, "template <int kNT, int kSteps",
                                      "// wgmma kernels:")
    # the forward's and dq's producers load K/V tiles alike
    kv_load = "        mbar_arrive_expect_tx(&full[s], 2 * C::kKV);"
    stale_kv = ("        if (t * kBN >= 2048) {\n"
                "          mbar_arrive(&full[s]);\n"
                "          continue;\n"
                "        }\n" + kv_load)
    out["stale_stage"] = _within(
        _within(_within(src, *fwd_wg, kv_load, stale_kv), *dq_wg, kv_load,
                stale_kv),
        *dkv_wg, "if (lane == 0) {\n          mbar_arrive_expect_tx",
        "if (lane == 0 && q0 < 2048) {\n          mbar_arrive_expect_tx")
    # the first k-step only: read K-major, an operand spans HD rows of 128
    # bytes, which stays inside the tile there (and not further on)
    out["transpose_v"] = _within(
        src, *fwd_wg, "wgmma_rs<HD, 1>(o, p[kk]",
        "if (kk == 0) wgmma_rs<HD, 0>(o, p[0], desc_mn_major(vt, kBN, 0), "
        "1); else wgmma_rs<HD, 1>(o, p[kk]")
    out["transpose_do"] = _within(
        src, *dkv_wg, "wgmma_rs<HD, 1>(dv_acc, p16[kk],",
        "if (c0 + kk == 0) wgmma_rs<HD, 0>(dv_acc, p16[0], "
        "desc_mn_major(dot, kBM, 0), 1); else wgmma_rs<HD, 1>(dv_acc, "
        "p16[kk],")
    out["transpose_k"] = _within(
        src, *dq_wg, "wgmma_rs<HD, 1>(acc, ds16[kk],",
        "if (c0 + kk == 0) wgmma_rs<HD, 0>(acc, ds16[0], "
        "desc_mn_major(kt, kBN, 0), 1); else wgmma_rs<HD, 1>(acc, ds16[kk],")
    out["mask_fwd_wgmma"] = _within(
        src, *fwd_wg, "(causal && k0 + kBN - 1 > row0 + offset)", "false")
    out["mask_dq_wgmma"] = _within(
        src, *dq_wg, "(causal && j0 + kKC - 1 > row0 + offset)", "false")
    out["mask_dkv_wgmma"] = _within(
        src, *dkv_wg, "(causal && kw0 + 63 > q0 + offset)", "false")
    return out


def _wgmma_header_mutants(src: str, header: str):
    """``src`` with ``wgmma_bf16.cuh`` inlined, for the faults that live in
    the header."""
    old = "CU_TENSOR_MAP_SWIZZLE_128B;"  # how TMA writes the tiles
    if header.count(old) != 1:
        raise ValueError(f"{old!r} is not in the header once")
    inc = '#include "wgmma_bf16.cuh"'
    if inc not in src:
        raise ValueError(f"{inc} not found")
    return {"swizzle_wgmma": src.replace(
        inc, header.replace("#pragma once\n", "").replace(
            old, "CU_TENSOR_MAP_SWIZZLE_NONE;"))}


def _one_term(src: str, start: str, end: str) -> str:
    """``src`` with every 3xTF32 product between ``start`` and ``end`` cut
    to its hi.hi term, and the two-term v.dO of bf16 v to v.dO_hi: one-term
    TF32, about 11 of fp32's 24 mantissa bits in each operand."""
    i = src.index(start)
    j = src.index(end, i)
    body = src[i:j].replace("mma_3xtf32(", "mma_1xtf32(")
    for t, lo in (("t0", "blo[0], blo[1]"), ("t1", "blo[2], blo[3]")):
        old = f"mma_tf32_1688({t}, a, {lo});"
        if old not in body:
            raise ValueError(f"{old!r} not found")
        body = body.replace(old, "")
    if "mma_1xtf32(" not in body:
        raise ValueError("no 3xTF32 product in the region")
    one = ("__device__ __forceinline__ void mma_1xtf32(float* c, "
           "const uint32_t* a_hi, const uint32_t*, const uint32_t* b_hi, "
           "const uint32_t*) { mma_tf32_1688(c, a_hi, b_hi[0], b_hi[1]); }"
           "\n\n")
    return src[:i] + one + body + src[j:]


def _touched(fault: str, tag: str, s: int):
    """The kernels that ``fault`` changes at shape ``tag`` (sequence
    length ``s``): every kernel runs on the tensor cores; bf16 q/k/v run
    the forward, dq and the dk/dv template on wgmma at head dims 64 and
    128 (the Llama and GPT-2 shapes) and on ``mma.sync`` at 256
    (``d256``); fp32 q/k run 3xTF32; the dk/dv template serves the split
    dk/dv and the fused backward."""
    bf16 = tag.endswith("/bf16")
    mma = tag.startswith("d256/")   # bf16 mma.sync kernels
    wg = bf16 and not mma           # bf16 wgmma kernels
    dq = ("flash_bwd_dq",)
    dkv = ("flash_bwd_dkv", "flash_bwd_fused")
    tf32_dkv = () if bf16 else dkv
    return {"clean": (),
            "q_tile": tf32_dkv if s > 2048 else (),
            "mask_fwd_mma": ("flash_fwd",) if mma else (),
            "mask_fwd_tf32": () if bf16 else ("flash_fwd",),
            "mask_dq_mma": dq if mma else (),
            "mask_dq_tf32": () if bf16 else dq,
            "mask_dkv_mma": dkv if mma else (),
            "mask_dkv_tf32": tf32_dkv,
            "tf32_1term_dkv": tf32_dkv,
            "prefetch": ("flash_fwd",) if s > 2048 and not bf16 else (),
            "swizzle_wgmma": ("flash_fwd", *dq, *dkv) if wg else (),
            "stale_stage": ("flash_fwd", *dq, *dkv) if wg and s > 2048
            else (),
            "transpose_v": ("flash_fwd",) if wg else (),
            "transpose_do": dkv if wg else (),
            "transpose_k": dq if wg else (),
            "mask_fwd_wgmma": ("flash_fwd",) if wg else (),
            "mask_dq_wgmma": dq if wg else (),
            "mask_dkv_wgmma": dkv if wg else (),
            }[fault]


def _latent_mutants(src: str):
    nibbles = src
    for i in ("0", "1"):
        old = f"const int hi{i} = raw.{'xy'[int(i)]} >> 4, lo{i} = " \
              f"raw.{'xy'[int(i)]} & 0xF;"
        if old not in nibbles:
            raise ValueError(f"{old!r} not found")
        nibbles = nibbles.replace(old, old.replace(f"hi{i} =", "TMP =")
                                  .replace(f"lo{i} =", f"hi{i} =")
                                  .replace("TMP =", f"lo{i} ="))
    old = "const int kv_end = min(qpos0 + last_pair / nh + 1, maxp * ps);"
    if old not in src:
        raise ValueError(f"{old!r} not found")
    last_page = src.replace(
        old, "const int kv_end = min(qpos0 + last_pair / nh + 1, maxp * ps)"
             " - ((qlen_row == 1 && qpos0 >= 512) ? ps : 0);")
    # latent_mma, through which every product goes, reduced to hi.hi
    one_term = _within(
        src, "latent_mma(float* c", "// the B operand bits",
        "  if constexpr (TERMS == 3) {\n"
        "    mma_3xtf32(c, a_hi, a_lo, b_hi, b_lo);\n"
        "  } else {\n"
        "    mma_tf32_1688(c, a_lo, b_hi[0], b_hi[1]);\n"
        "    mma_tf32_1688(c, a_hi, b_hi[0], b_hi[1]);\n"
        "  }\n",
        "  mma_tf32_1688(c, a_hi, b_hi[0], b_hi[1]);\n")
    # the wgmma route: bf16_terms, through which q and p go, keeps hi only
    wg_one_term = _within(
        src, "void bf16_terms(float x0", "// Items are",
        "lo = pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));",
        "lo = 0u;")
    wg_mask = _within(
        src, "latent_ragged_paged_attention_wgmma_kernel(", "wgmma_smem_bytes",
        "if (!(pos < kv_stop && pos <= qp)) v = -INFINITY;",
        "if (!(pos < kv_stop)) v = -INFINITY;")
    merge = _within(
        src, "latent_merge_kernel(const float*", "template <int NT, int KIND>",
        "latent_live_slices(latent_kv_end(w, pair / kBM, nh, cap), "
        "split_len);",
        "latent_live_slices(latent_kv_end(w, pair / kBM, nh, cap), "
        "split_len) - 1;")
    return {"nf4_nibbles": nibbles, "last_page": last_page,
            "tf32_1term_latent": one_term, "bf16_1term_latent": wg_one_term,
            "mask_latent_wgmma": wg_mask, "merge_latent": merge}


def _core_mutants(header: str):
    """``paged_decode.cuh`` with each decode-core fault."""
    def sub(old, new):
        if header.count(old) != 1:
            raise ValueError(f"{old!r} is not in the header once")
        return header.replace(old, new)
    return {
        # the loop that sums the slices' weighted outputs
        "split_merge": sub("for (int sl = 0; sl < n_live; ++sl)\n      a = ",
                           "for (int sl = 0; sl < n_live - 1; ++sl)\n"
                           "      a = "),
        "kv_ring": sub("    if (kv0 < end) {",
                       "    if (kv0 < end && kv0 < 2048) {"),
        # in the scalar loop's q and in mma's A operand
        "decode_group": sub("core_float(q[hh * hd + d])",
                            "core_float(q[(hh == nq - 1 && nq > 1 ? hh - 1 "
                            ": hh) * hd + d])").replace(
            "(q)[r * hd + d]",
            "(q)[(r == nq - 1 && nq > 1 ? r - 1 : r) * hd + d]")}


def _with_header(src: str, header: str) -> str:
    """``src`` with ``#include "paged_decode.cuh"`` replaced by ``header``
    (its ``#pragma once`` dropped)."""
    inc = '#include "paged_decode.cuh"'
    if inc not in src:
        raise ValueError(f"{inc} not found")
    return src.replace(inc, header.replace("#pragma once\n", ""))


def _build_mutants(texts: dict) -> dict:
    """Builds each ``{name: source}`` under ``csrc/_build/``, one ``nvcc``
    per mutant, all at once; returns ``{name: library path}``."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        src = os.path.join(build.BUILD_DIR, f"mutant-{name}.cu")
        so = os.path.join(build.BUILD_DIR, f"mutant-{name}.so")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            build.nvcc_command(src, so), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    out = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for mutant {name}:\n{log}")
        out[name] = so
    return out


def _latent_faults(cs):
    """The latent kernel, clean and with each fault, on every batch of
    ``chip_smoke.LATENT_CASES``; returns the gates that missed."""
    name = "latent_ragged_paged_attention"
    with open(os.path.join(build.CSRC, build.SOURCES[name])) as f:
        src = f.read()
    # bf16 pages run the wgmma route, int8 and nf4 the mma.sync one
    wg = tuple(c for c in cs.LATENT_CASES if c.endswith("/bf16"))
    mma = tuple(c for c in cs.LATENT_CASES if not c.endswith("/bf16"))
    touched = {"clean": (), "nf4_nibbles": ("gpt2_mla/nf4",),
               "last_page": mma, "tf32_1term_latent": mma,
               "bf16_1term_latent": wg,
               # every batch splits its decode rows, on both routes
               "merge_latent": tuple(cs.LATENT_CASES),
               # at nh 32 an item of 32 pairs is one query, whose range
               # already ends at its diagonal: only nh 12 (three queries
               # an item) can tell
               "mask_latent_wgmma": ("gpt2_mla/bf16",)}
    missed = []
    real = build.load_library(name)
    libs = _build_mutants(_latent_mutants(src))
    for fault in ("clean", *libs):
        build._LOADED[name] = real if fault == "clean" else ctypes.CDLL(
            libs[fault])
        for case, shape in cs.LATENT_CASES.items():
            res = cs.latent_case(case, *shape, check=False)
            print(json.dumps({"fault": fault, "shape": case, **res}),
                  flush=True)
            hit = res["err_over_limit"] > 1.0
            if hit != (case in touched[fault]):
                missed.append(f"{fault} {case}")
    build._LOADED[name] = real
    return missed


def _core_faults(cs):
    """The ragged and paged decode kernels, clean and with each decode-core
    fault, against phase 3's and phase 10's gates; returns the gates that
    missed (every fault touches both, the clean kernels neither)."""
    import torch
    names = ("ragged_paged_attention", "paged_attention")
    real = {n: build.load_library(n) for n in names}
    with open(os.path.join(build.CSRC, "paged_decode.cuh")) as f:
        header = f.read()
    texts = {}
    for fault, mutated in _core_mutants(header).items():
        for n in names:
            with open(os.path.join(build.CSRC, build.SOURCES[n])) as f:
                texts[f"{fault}-{n}"] = _with_header(f.read(), mutated)
    libs = _build_mutants(texts)
    missed = []
    for fault in ("clean", *_core_mutants(header)):
        for n in names:
            build._LOADED[n] = real[n] if fault == "clean" else \
                ctypes.CDLL(libs[f"{fault}-{n}"])
        ratios, _, pad = cs.ragged_serving_gate()
        gates = {"phase3": max(ratios)}
        for batch in (8, 64):
            for dname, dtype in (("bf16", torch.bfloat16),
                                 ("fp32", torch.float32)):
                args, seq_lens, _ = cs.paged_inputs(batch, dtype, seed=batch)
                got = cs.paged_attention_cuda(*args)
                torch.cuda.synchronize()
                want = cs.paged_attention_reference(*args)
                gates[f"phase10/batch{batch}/{dname}"] = cs.paged_agreement(
                    got, want, seq_lens, dtype)[0]
                del args, got, want
        torch.cuda.empty_cache()
        # a NaN output (stages read that no copy ever wrote) reads as an
        # infinite error, as the gates refuse it
        gates = {g: r if r == r else float("inf") for g, r in gates.items()}
        print(json.dumps({"fault": fault, "err_over_limit": gates,
                          "padding_nonzero": pad}), flush=True)
        hits = {g: r > 1.0 for g, r in gates.items()}
        if fault == "clean":
            missed += [f"clean {g}" for g, hit in hits.items() if hit]
        else:
            if not hits["phase3"]:
                missed.append(f"{fault} phase3")
            if not any(hit for g, hit in hits.items() if g != "phase3"):
                missed.append(f"{fault} phase10")
    for n in names:
        build._LOADED[n] = real[n]
    return missed


def main(argv=None) -> int:
    import torch
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    groups = set(sys.argv[1:] if argv is None else argv) or \
        {"flash", "latent", "core"}
    if not groups <= {"flash", "latent", "core"}:
        print(f"planted_faults: unknown groups {sorted(groups)} (flash, "
              f"latent, core)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("planted_faults: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    missed = []
    if "flash" in groups:
        missed += _flash_faults(cs)
    if "latent" in groups:
        missed += _latent_faults(cs)
    if "core" in groups:
        missed += _core_faults(cs)
    if missed:
        print(f"gates missed: {missed}", file=sys.stderr)
        return 1
    return 0


def _flash_faults(cs):
    """The flash kernels, clean and with each fault, at the shapes of
    phase 6 (and phase 8's oracle for ``tf32_1term_dkv``); returns the
    gates that missed."""
    import torch
    with open(os.path.join(build.CSRC, build.SOURCES["flash_attention"])) as f:
        src = f.read()
    missed = []
    real = build.load_library("flash_attention")
    shapes = (("llama/fp32_qk_bf16_v", cs.LLAMA_ATTN, "fp32_qk_bf16_v"),
              ("llama/fp32", cs.LLAMA_ATTN, "fp32"),
              ("llama/bf16", cs.LLAMA_ATTN, "bf16"),
              ("gpt2/bf16", cs.GPT2_ATTN, "bf16"),
              # the bf16 mma.sync kernels (head dims 32 and 256)
              ("d256/bf16", (1, 1024, 2, 256), "bf16"))
    with open(os.path.join(build.CSRC, "wgmma_bf16.cuh")) as f:
        wgmma_header = f.read()
    libs = _build_mutants({**_mutants(src),
                           **_wgmma_header_mutants(src, wgmma_header)})
    for name in ("clean", *libs):
        lib = real if name == "clean" else ctypes.CDLL(libs[name])
        build._LOADED["flash_attention"] = lib
        for tag, (b, s, h, d), types in shapes:
            q, k, v, do = cs.flash_inputs(b, s, s, h, d, types, seed=1)
            res, _, _ = cs.flash_ratios(q, k, v, do, tag=tag)
            ratios = {n: r[0] for n, r in res.items()}
            print(json.dumps({"fault": name, "shape": tag,
                              "err_over_limit": ratios,
                              "max_abs_err": {n: r[1] for n, r in
                                              res.items()}}), flush=True)
            touched = _touched(name, tag, s)
            if name == "clean":
                missed += [f"clean {tag} {n}" for n, r in ratios.items()
                           if not r <= 1.0]
            missed += [f"{name} {tag} {n}" for n in touched
                       if not ratios[n] > 1.0]
            del q, k, v, do
            torch.cuda.empty_cache()
        if name == "tf32_1term_dkv":
            rep = cs.train_oracle_case(
                "gpt2_widths", cs.GPTConfig(num_layers=2, vocab_size=1024,
                                            dtype="float32"), 2, 256,
                check=False)
            print(json.dumps({"fault": name, "train_oracle": "gpt2_widths",
                              **{k: rep[k] for k in (
                                  "loss_rel_diff", "param_update_rel_diff",
                                  "param_max_abs_diff", "within_limits")}}),
                  flush=True)
            if rep["within_limits"]:
                missed.append(f"{name} train oracle gpt2_widths")
    build._LOADED["flash_attention"] = real
    return missed


if __name__ == "__main__":
    sys.exit(main())
