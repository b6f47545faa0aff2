"""Planted faults in the flash-attention kernels and in the latent ragged
paged attention kernel, against the gates of ``chip_smoke.py``'s phases
6 and 9.

    python -m hetu_tpu_torch.csrc.planted_faults     (on the card, from
                                                     the repository root)

Each fault is a text replacement in a copy of a kernel's source written
under ``csrc/_build/`` (the checkout's own sources stay as they are),
built with the flags of ``build.py`` and loaded in place of the real
library; the kernels then run at the main paths' shapes and
``chip_smoke.flash_ratios`` / ``chip_smoke.latent_case`` read each
kernel's error over its limit.  A gate that works reads above 1 for the
kernels (or page kinds) a fault touches.  The flash faults:

- ``kv_tile``: the dq kernel's KV loop stops one tile early for q rows
  at or past 2048;
- ``mask``: the causal mask of the scalar backward kernels shifted by
  one (a query no longer sees its own key), in the dq kernel and in the
  scalar dk/dv template that the fused kernel shares (bf16 dq, and every
  backward kernel of the other type mixes);
- ``mask_fwd_mma``: the causal mask of the bf16 tensor-core forward
  shifted by one (a query also sees the next key);
- ``mask_dkv_mma``: the same in the bf16 tensor-core dk/dv template
  (split and fused);
- ``prefetch``: the bf16 forward's cp.async double buffer skips the copy
  of the last KV tile for q tiles at or past row 2048, so that tile is
  read from the buffer of two tiles before.

The latent faults, which the short rows of a batch cannot catch:

- ``nf4_nibbles``: the two 4-bit codes of a byte swapped when the latent
  kernel dequantizes packed pages (touches the nf4 pages only);
- ``last_page``: the last page of a decode row whose context is longer
  than 1024 tokens dropped (touches the Llama-width batch only: its
  decode rows reach 4096 tokens, the GPT-2-width ones 1024).

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
    dq = ("flash_bwd_dq_kernel(const TQ*", "// kernels 4")
    dkv = ("flash_bwd_dkv_kernel(const TQ*", "// launchers")
    tile = _within(src, *dq,
                   "kv_tiles_for(q0, sq, sk, causal, offset);",
                   "kv_tiles_for(q0, sq, sk, causal, offset) - (q0 >= 2048);")
    fwd_mma = ("flash_fwd_mma_kernel(const bf16*", "dkv_mma_smem_bytes")
    dkv_mma = ("flash_bwd_dkv_mma_kernel(const bf16*", "// launchers")
    mask = _within(src, *dq, "j <= qi[r] + offset", "j < qi[r] + offset")
    mask = _within(mask, *dkv, "kj[r] <= i + offset", "kj[r] < i + offset")
    mask_fwd = _within(src, *fwd_mma, "j <= row + offset",
                       "j <= row + offset + 1")
    mask_dkv = _within(src, *dkv_mma, "key <= qi + offset",
                       "key <= qi + offset + 1")
    prefetch = _within(src, *fwd_mma, "if (t + 1 < n_kv) {",
                       "if (t + 1 < n_kv - (q0 >= 2048)) {")
    return {"kv_tile": tile, "mask": mask, "mask_fwd_mma": mask_fwd,
            "mask_dkv_mma": mask_dkv, "prefetch": prefetch}


def _touched(fault: str, tag: str, s: int):
    """The kernels that ``fault`` changes at shape ``tag`` (sequence
    length ``s``): the bf16 forward and dk/dv kernels are the tensor-core
    ones, every other kernel and type mix the scalar ones."""
    bf16 = tag.endswith("/bf16")
    return {"clean": (),
            "kv_tile": ("flash_bwd_dq",) if s > 2048 else (),
            "mask": ("flash_bwd_dq",) if bf16 else
                    ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused"),
            "mask_fwd_mma": ("flash_fwd",) if bf16 else (),
            "mask_dkv_mma": ("flash_bwd_dkv", "flash_bwd_fused") if bf16
                            else (),
            "prefetch": ("flash_fwd",) if bf16 and s > 2048 else (),
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
             " - ((qlen_row == 1 && qpos0 >= 1024) ? ps : 0);")
    return {"nf4_nibbles": nibbles, "last_page": last_page}


def _build_mutant(name: str, text: str) -> str:
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    src = os.path.join(build.BUILD_DIR, f"mutant-{name}.cu")
    so = os.path.join(build.BUILD_DIR, f"mutant-{name}.so")
    with open(src, "w") as f:
        f.write(text)
    subprocess.run(build.nvcc_command(src, so), check=True,
                   capture_output=True, text=True)
    return so


def _latent_faults(cs):
    """The latent kernel, clean and with each fault, on every batch of
    ``chip_smoke.LATENT_CASES``; returns the gates that missed."""
    name = "latent_ragged_paged_attention"
    with open(os.path.join(build.CSRC, build.SOURCES[name])) as f:
        src = f.read()
    touched = {"clean": (), "nf4_nibbles": ("gpt2_mla/nf4",),
               "last_page": ("llama3_8b_mla/bf16",)}
    missed = []
    real = build.load_library(name)
    for fault, text in [("clean", src), *_latent_mutants(src).items()]:
        build._LOADED[name] = real if fault == "clean" else ctypes.CDLL(
            _build_mutant(fault, text))
        for case, shape in cs.LATENT_CASES.items():
            res = cs.latent_case(case, *shape, check=False)
            print(json.dumps({"fault": fault, "shape": case, **res}),
                  flush=True)
            hit = res["err_over_limit"] > 1.0
            if hit != (case in touched[fault]):
                missed.append(f"{fault} {case}")
    build._LOADED[name] = real
    return missed


def main() -> int:
    import torch
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("planted_faults: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(os.path.join(build.CSRC, build.SOURCES["flash_attention"])) as f:
        src = f.read()
    missed = []
    real = build.load_library("flash_attention")
    shapes = (("llama/fp32_qk_bf16_v", cs.LLAMA_ATTN, "fp32_qk_bf16_v"),
              ("llama/bf16", cs.LLAMA_ATTN, "bf16"),
              ("gpt2/bf16", cs.GPT2_ATTN, "bf16"))
    for name, text in [("clean", src), *_mutants(src).items()]:
        lib = real if name == "clean" else ctypes.CDLL(
            _build_mutant(name, text))
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
    build._LOADED["flash_attention"] = real
    missed += _latent_faults(cs)
    if missed:
        print(f"gates missed: {missed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
