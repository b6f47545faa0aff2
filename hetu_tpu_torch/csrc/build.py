"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``.cu`` source in this directory compiles on its own into a shared
library with a plain C interface under ``csrc/_build/`` (listed in
``.gitignore``), at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -I csrc -o _build/<name>-<hash>.so
         <name>.cu

Sources share the headers of this directory (``mma_bf16.cuh``).  The
file name carries a hash of the source, every header and the flags, so
an edited source or header never loads a stale library.  ``build()``
starts one ``nvcc`` per source, all at once, and returns what ``-Xptxas
-v`` reported (registers, shared memory, spills) for each; the report is
kept beside the library (``<name>-<hash>.ptxas.txt``) for later calls.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

CSRC = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(CSRC, "_build")
SOURCES = {"ragged_paged_attention": "ragged_paged_attention.cu",
           "flash_attention": "flash_attention.cu",
           "latent_ragged_paged_attention":
               "latent_ragged_paged_attention.cu",
           "paged_attention": "paged_attention.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH); the CUDA kernels are built from source")


def nvcc_command(src: str, out: str) -> list:
    """The ``nvcc`` command line that builds ``src`` into ``out``."""
    return [nvcc_path(), *NVCC_FLAGS, "-I", CSRC, "-o", out, src]


def _target(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [SOURCES[name], *headers]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile ``names`` (default: every source) in parallel.  Returns
    ``{name: {"so", "ptxas", "seconds", "cached"}}``; raises with the
    compiler's output when a build fails."""
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs, out = {}, {}
    t0 = time.perf_counter()
    for name in names:
        so = _target(name)
        if os.path.exists(so):
            log = so[:-len(".so")] + ".ptxas.txt"
            text = ""
            if os.path.exists(log):
                with open(log) as f:
                    text = f.read()
            out[name] = {"so": so, "ptxas": text, "seconds": 0.0,
                         "cached": True}
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = nvcc_command(os.path.join(CSRC, SOURCES[name]), tmp)
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), so, tmp)
    for name, (proc, so, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                               f"(exit {proc.returncode}):\n{log}")
        with open(so[:-len(".so")] + ".ptxas.txt", "w") as f:
            f.write(log)
        os.replace(tmp, so)
        out[name] = {"so": so, "ptxas": log,
                     "seconds": time.perf_counter() - t0, "cached": False}
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name]["so"])
        _LOADED[name] = lib
    return lib
