"""Time the bf16 flash-attention kernels of several checkouts on one card,
in turns.

    python3 tools/compare_flash_kernels.py [--out FILE] P C C P

Each argument is the root of a checkout of this repository (here P the
parent's, C the change's).  For each, in order and in a fresh process,
with that checkout's kernels built from its own sources and its own
``chip_smoke.py``: the four flash kernels (forward, fused backward, split
dq and split dk/dv) on all-bf16 q/k/v at phase 6's Llama-3-8B (b 2, s 4096,
h 32, d 128) and GPT-2 (b 4, s 1024, h 12, d 64) shapes, causal, first
held to phase 6's gates (``flash_ratios``), then timed with CUDA events
around the wrapper's calls (``ms``, host work included), by the replays of
a CUDA graph of one call (``device_ms``) and by the host's time a call
enqueued back to back (``host_us``); beside them, at each shape and the
same for every checkout, PyTorch's ``scaled_dot_product_attention``
forward (graph replay) and backward (``torch.profiler`` kernel time, in
all and by kernel name) by ``tools/sdpa_times.py``, the checkout's own
``chip_smoke.library_times`` on the same inputs, the one torch op that
computes the split backward's delta, and the split backward's total
(delta op, dq and dk/dv); dq on its other routes (fp32 and mixed q/k/v at
the Llama shape, bf16 at head dims 256 and 32) by graph replay; then
phase 7's GPT-2 training run (step time, launches by route, profile) as
that checkout defines it.  Standard output gets one summary line per run, with
the card's name and power limit; with ``--out FILE`` every JSON line also
goes to FILE, with the checkout beside it.  Needs a CUDA device.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import compare_decode_kernels as decode  # noqa: E402
from sdpa_times import sdpa_times  # noqa: E402

SHAPES = {"llama": (2, 4096, 32, 128), "gpt2": (4, 1024, 12, 64)}


def library(cs, torch, shape, q, k, v, do, o):
    """SDPA's times on these inputs (a yardstick only), by this tool's
    ``sdpa_times`` (the function ``chip_smoke.py`` reads too) for every
    checkout; beside it the checkout's own ``chip_smoke.library_times`` on
    the same inputs (seed 1), so that one call reads both scripts' SDPA
    backward; and the delta op's device time."""
    sdpa = sdpa_times(q, k, v, do, graph_ms=cs.graph_ms,
                      events_ms=cs.cuda_time_ms)
    smoke = cs.library_times(*shape, "bf16", seed=1)
    return {"sdpa_fwd_device_ms": sdpa["fwd_device_ms"],
            "sdpa_bwd_device_ms": sdpa["bwd_device_ms"],
            "sdpa_bwd_kernels": sdpa["bwd_kernels"],
            "smoke_sdpa_bwd_device_ms": smoke["bwd_device_ms"],
            "delta_op_device_ms": cs.graph_ms(
                lambda: torch.einsum("bshd,bshd->bsh", do.float(),
                                     o.float()), iters=20)}


def one(root: str) -> None:
    """The measurements of one checkout, in this process."""
    root = os.path.abspath(root)
    os.chdir(root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    import torch
    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    fa = cs.fa
    cs.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, (b, s, h, d) in SHAPES.items():
        q, k, v, do = cs.flash_inputs(b, s, s, h, d, "bf16", seed=1)
        scale = d ** -0.5
        res, (ro, rl, delta), _ = cs.flash_ratios(q, k, v, do,
                                                  tag=f"{name}/bf16")
        calls = {
            "flash_fwd": lambda: fa.flash_fwd_cuda(q, k, v, scale, True),
            "flash_bwd_fused": lambda: fa.flash_bwd_fused_cuda(
                q, k, v, ro, rl, do, scale, True),
            "flash_bwd_dq": lambda: fa.flash_bwd_dq_cuda(
                q, k, v, do, rl, delta, scale, True),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_cuda(
                q, k, v, do, rl, delta, scale, True)}
        out = {}
        for kernel, call in calls.items():
            out[kernel] = {"err_over_limit": res[kernel][0],
                           "ms": cs.cuda_time_ms(call, warmup=3, iters=10),
                           "device_ms": cs.graph_ms(call, iters=10),
                           "host_us": decode.host_us(call, torch),
                           "bound_ms": cs.flash_work(
                               kernel, b, s, s, h, d, q.dtype,
                               v.dtype)["bound_ms"]}
        out["library"] = library(cs, torch, (b, s, h, d), q, k, v, do, ro)
        # the bf16 split backward: the delta op, dq and dk/dv
        out["split_bwd_device_ms"] = (
            out["library"]["delta_op_device_ms"] +
            out["flash_bwd_dq"]["device_ms"] +
            out["flash_bwd_dkv"]["device_ms"])
        print(json.dumps({"phase": "compare_flash", "shape": name, **out}),
              flush=True)
        del q, k, v, do, ro, rl, delta
        torch.cuda.empty_cache()
    # dq on its other routes: 3xTF32 (fp32 and mixed q/k/v) and bf16
    # mma.sync (head dims 32 and 256)
    other = {}
    for name, (b, s, h, d), types in (
            ("llama/fp32", SHAPES["llama"], "fp32"),
            ("llama/fp32_qk_bf16_v", SHAPES["llama"], "fp32_qk_bf16_v"),
            ("d256/bf16", (1, 4096, 8, 256), "bf16"),
            ("d32/bf16", (4, 1024, 8, 32), "bf16")):
        q, k, v, do = cs.flash_inputs(b, s, s, h, d, types, seed=1)
        scale = d ** -0.5
        o, lse = fa.flash_fwd_cuda(q, k, v, scale, True)
        delta = torch.einsum("bshd,bshd->bsh", do.float(), o.float())
        other[name] = cs.graph_ms(lambda: fa.flash_bwd_dq_cuda(
            q, k, v, do, lse, delta, scale, True), iters=10)
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "compare_flash", "shape": "dq_other_routes",
                      "device_ms": other}), flush=True)
    cs.phase_train("gpt2_small")


def summary(lines):
    """The numbers the comparison reads, from one run's JSON lines."""
    out = {}
    for obj in lines:
        phase = obj.get("phase")
        if phase == "device":
            out["device"] = obj["nvidia_smi"]
        elif phase == "compare_flash":
            out[obj["shape"]] = {
                k: ({m: round(x, 4) for m, x in v.items()
                     if isinstance(x, float)}
                    if isinstance(v, dict) else v)
                for k, v in obj.items() if k not in ("phase", "shape")}
        elif phase == "train_main_path":
            out["phase7_gpt2"] = {k: obj.get(k) for k in (
                "ms_per_step", "tokens_per_s", "wgmma_launches")}
        elif phase == "train_profile":
            out["phase7_gpt2_profile"] = {k: obj[k] for k in (
                "device_busy_s", "idle_share", "flash_attention_s",
                "flash_share_of_busy")}
    return out


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(sys.argv[2])
        sys.exit(0)
    args = sys.argv[1:]
    out = None
    if args[:1] == ["--out"]:
        out, args = args[1], args[2:]
    sys.exit(decode.main(args, out, script=__file__, summarize=summary))
