"""Read the dq kernels on the query rows that see one key against the
fp64 plain version and its rounding bound, over several seeds, for
several checkouts in turns.

    python3 tools/single_key_rows.py [--out FILE] ROOT [ROOT ...]

Each argument is the root of a checkout of this repository.  For each,
in order and in a fresh process, with that checkout's kernels and
``chip_smoke.py``: at phase 6's Llama-3-8B (b 2, s 4096, h 32, d 128) and
GPT-2 (b 4, s 1024, h 12, d 64) shapes and the ring's blocks of phase 24
(b 1, s 4096 and the sym half 2048, h 32, d 128), causal, in bf16 and in
the LLaMA path's fp32 q/k with bf16 v, seeds 1 to 10 (phase 6 takes seed
1, phase 24 seed 4).  A query row that sees one key has dq = 0 exactly;
``chip_smoke.flash_ratios`` holds both dq kernels there against the fp64
plain version (``single_key_fp64``) within ``single_key_ulps``' bound.
Each line gives, over that bound, the split dq kernel (on the plain
forward's out and lse, delta from the split backward's torch op), the
fused kernel, the plain fp32 version, and the split kernel fed two faults
of delta: rounded to bf16, and left out (0).  Beside them the older rule,
the kernel's and the plain version's largest |dq| there over 2**-16 of
dq's RMS (``CANCEL_FLOOR``).  Standard output gets one summary line per
run, with the card's name and power limit; with ``--out FILE`` every
JSON line also goes to FILE.  Needs a CUDA device.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import compare_decode_kernels as decode  # noqa: E402

SHAPES = {"llama": (2, 4096, 32, 128), "gpt2": (4, 1024, 12, 64),
          "ring_block": (1, 4096, 32, 128), "ring_sym_half": (1, 2048, 32, 128)}
SEEDS = tuple(range(1, 11))
TYPES = ("bf16", "fp32_qk_bf16_v")
READINGS = ("split_over_bound", "fused_over_bound", "plain_over_bound",
            "fault_delta_bf16_over_bound", "fault_delta_zero_over_bound",
            "split_over_floor", "plain_over_floor")


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
        for types in TYPES:
            for seed in SEEDS:
                q, k, v, do = cs.flash_inputs(b, s, s, h, d, types,
                                              seed=seed)
                ro, rl = fa.flash_fwd_reference(q, k, v, scale, True)
                want = fa.flash_bwd_reference(q, k, v, ro, rl, do, scale,
                                              True)[0]
                delta = torch.einsum("bshd,bshd->bsh", do.float(),
                                     ro.float())
                rows = cs.single_key_rows(b, s, s, True, None, 0, q.device)
                dq64, bound = cs.single_key_fp64(q, k, v, do, rows, True,
                                                 None, 0, scale)

                def split(dl):
                    return fa.flash_bwd_dq_cuda(q, k, v, do, rl, dl, scale,
                                                True)

                got = {"split": split(delta),
                       "fused": fa.flash_bwd_fused_cuda(
                           q, k, v, ro, rl, do, scale, True)[0],
                       "plain": want,
                       "fault_delta_bf16": split(
                           delta.bfloat16().float()),
                       "fault_delta_zero": split(torch.zeros_like(delta))}
                torch.cuda.synchronize()
                floor = cs.CANCEL_FLOOR * want.float().pow(2).mean().sqrt()
                line = {"phase": "single_key_rows", "shape": name,
                        "types": types, "seed": seed,
                        "rows": int(rows.sum().item()),
                        "bound_max": bound.max().item(),
                        "floor": floor.item()}
                for key, dq in got.items():
                    err = (dq[rows].double() - dq64).abs()
                    line[f"{key}_over_bound"] = (err / bound).max().item()
                for key in ("split", "plain"):
                    line[f"{key}_over_floor"] = (
                        got[key][rows].float().abs().max() / floor).item()
                print(json.dumps(line), flush=True)
                del q, k, v, do, ro, rl, want, delta, got, dq64, bound
                torch.cuda.empty_cache()


def summary(lines):
    """Each shape's and type mix's largest reading over the seeds (a
    fault's least), from one run's JSON lines."""
    out = {}
    for obj in lines:
        if obj.get("phase") == "device":
            out["device"] = obj["nvidia_smi"]
        elif obj.get("phase") == "single_key_rows":
            row = out.setdefault(f"{obj['shape']}/{obj['types']}", {})
            for key in READINGS:
                # the largest reading over the seeds, the faults' least
                pick = min if key.startswith("fault") else max
                row[key] = pick(row.get(key, obj[key]), obj[key])
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
