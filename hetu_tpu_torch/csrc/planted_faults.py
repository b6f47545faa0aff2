"""Planted faults in the flash-attention kernels, against the gates of
``chip_smoke.py``'s phase 6.

    python -m hetu_tpu_torch.csrc.planted_faults     (on the card, from
                                                     the repository root)

Each fault is a text replacement in a copy of ``flash_attention.cu``
written under ``csrc/_build/`` (the checkout's own sources stay as they
are), built with the flags of ``build.py`` and loaded in place of the
real library; the kernels then run at the training path's shapes and
``chip_smoke.flash_ratios`` reads each kernel's error over its limit.
A gate that works reads above 1 for the kernels a fault touches.  The
faults:

- ``kv_tile``: the dq kernel's KV loop stops one tile early for q rows
  at or past 2048;
- ``mask``: the causal mask of the backward kernels shifted by one (a
  query no longer sees its own key), in the dq kernel and in the dk/dv
  template that the fused kernel shares.

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
    mask = _within(src, *dq, "j <= qi[r] + offset", "j < qi[r] + offset")
    mask = _within(mask, *dkv, "kj[r] <= i + offset", "kj[r] < i + offset")
    return {"kv_tile": tile, "mask": mask}


def _build_mutant(name: str, text: str) -> str:
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    src = os.path.join(build.BUILD_DIR, f"mutant-{name}.cu")
    so = os.path.join(build.BUILD_DIR, f"mutant-{name}.so")
    with open(src, "w") as f:
        f.write(text)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, src],
                   check=True, capture_output=True, text=True)
    return so


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
            touched = {"clean": (), "kv_tile": ("flash_bwd_dq",),
                       "mask": ("flash_bwd_dq", "flash_bwd_dkv",
                                "flash_bwd_fused")}[name]
            if name == "kv_tile" and s <= 2048:
                touched = ()           # no q row at or past 2048
            if name == "clean":
                missed += [f"clean {tag} {n}" for n, r in ratios.items()
                           if not r <= 1.0]
            missed += [f"{name} {tag} {n}" for n in touched
                       if not ratios[n] > 1.0]
            del q, k, v, do
            torch.cuda.empty_cache()
    build._LOADED["flash_attention"] = real
    if missed:
        print(f"gates missed: {missed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
