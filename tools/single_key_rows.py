"""Hold the bf16 split dq of several checkouts to the single-key-row floor
over several seeds, in turns.

    python3 tools/single_key_rows.py [--out FILE] P C

Each argument is the root of a checkout of this repository (P the
parent's, C the change's).  For each, in order and in a fresh process,
with that checkout's kernels and ``chip_smoke.py``: at phase 6's
Llama-3-8B (b 2, s 4096, h 32, d 128) and GPT-2 (b 4, s 1024, h 12, d 64)
shapes, bf16, causal, seeds 1 to 5 (phase 6 takes seed 1), the split dq
kernel on the plain forward's out and lse with delta from the split
backward's torch op.  A query row that sees one key has dq = 0 exactly,
and phase 6 holds the kernel against 0 there within 2**-16 of dq's RMS
(``CANCEL_FLOOR``).  Each line gives the kernel's largest |dq| on those
rows over that floor, the plain version's own, and how far the fp32 delta
lies from one summed in fp64 on those rows, in units of 2**-20 (an ulp of
values from 8 to 16, the size of delta there).  Standard output gets one
summary line per run, with the card's name and power limit; with ``--out
FILE`` every JSON line also goes to FILE.  Needs a CUDA device.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import compare_decode_kernels as decode  # noqa: E402

SHAPES = {"llama": (2, 4096, 32, 128), "gpt2": (4, 1024, 12, 64)}
SEEDS = (1, 2, 3, 4, 5)


def one(root: str) -> None:
    """The readings of one checkout, in this process."""
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
        scale = d ** -0.5
        for seed in SEEDS:
            q, k, v, do = cs.flash_inputs(b, s, s, h, d, "bf16", seed=seed)
            ro, rl = fa.flash_fwd_reference(q, k, v, scale, True)
            want = fa.flash_bwd_reference(q, k, v, ro, rl, do, scale,
                                          True)[0]
            delta = torch.einsum("bshd,bshd->bsh", do.float(), ro.float())
            got = fa.flash_bwd_dq_cuda(q, k, v, do, rl, delta, scale, True)
            torch.cuda.synchronize()
            rows = cs.single_key_rows(b, s, s, True, None, 0, q.device)
            floor = cs.CANCEL_FLOOR * want.float().pow(2).mean().sqrt()
            exact = (do.double() * ro.double()).sum(-1)      # [b, s, h]
            print(json.dumps({
                "phase": "single_key_rows", "shape": name, "seed": seed,
                "rows": int(rows.sum().item()), "floor": floor.item(),
                "kernel_over_floor": (got[rows].float().abs().max()
                                      / floor).item(),
                "plain_over_floor": (want[rows].float().abs().max()
                                     / floor).item(),
                "delta_err_ulp": ((delta[rows].double() - exact[rows])
                                  .abs().max() / 2.0 ** -20).item()}),
                flush=True)
            del q, k, v, do, ro, rl, want, delta, got
            torch.cuda.empty_cache()


def summary(lines):
    """Each shape's readings by seed, from one run's JSON lines."""
    out = {}
    for obj in lines:
        if obj.get("phase") == "device":
            out["device"] = obj["nvidia_smi"]
        elif obj.get("phase") == "single_key_rows":
            row = out.setdefault(obj["shape"], {})
            for key in ("kernel_over_floor", "plain_over_floor",
                        "delta_err_ulp"):
                row.setdefault(key, []).append(round(obj[key], 4))
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
