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
forward (graph replay) and backward (``torch.profiler`` kernel time), and
the one torch op that computes the split backward's delta; then phase 7's
GPT-2 training run (step time, launches by route, profile) as that
checkout defines it.  Standard output gets one summary line per run, with
the card's name and power limit; with ``--out FILE`` every JSON line also
goes to FILE, with the checkout beside it.  Needs a CUDA device.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import compare_decode_kernels as decode  # noqa: E402

SHAPES = {"llama": (2, 4096, 32, 128), "gpt2": (4, 1024, 12, 64)}


def library(cs, torch, q, k, v, do):
    """SDPA's device times on these inputs (a yardstick only), and the
    delta op's."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
    out = sdpa(qg, kg, vg, is_causal=True)
    prof = {"activities": [torch.profiler.ProfilerActivity.CPU,
                           torch.profiler.ProfilerActivity.CUDA]}

    def bwd():
        return torch.autograd.grad(out, (qg, kg, vg), dot, retain_graph=True)

    bwd()
    torch.cuda.synchronize()
    with torch.profiler.profile(**prof) as p:
        for _ in range(5):
            bwd()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in p.key_averages()
             if str(e.device_type).endswith("CUDA"))
    o = out.detach().transpose(1, 2).contiguous()
    return {"sdpa_fwd_device_ms": cs.graph_ms(
                lambda: sdpa(qt, kt, vt, is_causal=True), iters=20),
            "sdpa_bwd_device_ms": us / 1e3 / 5,
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
        out["library"] = library(cs, torch, q, k, v, do)
        print(json.dumps({"phase": "compare_flash", "shape": name, **out}),
              flush=True)
        del q, k, v, do, ro, rl, delta
        torch.cuda.empty_cache()
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
                k: ({m: round(x, 4) for m, x in v.items()}
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
