"""The mesh over NCCL, a GPU a rank: captured steps with collectives.

    python3 tools/mesh_nccl.py [--ranks 4] [--out FILE]

on a machine with at least ``--ranks`` cards.

Builds the port's kernels and runs ``chip_smoke.py`` phase 22's machinery
(``mesh_runs``) with ``--ranks`` rank processes, which on a machine with
that many cards join over NCCL (``parallel.mesh.choose_backend``), rank
``r`` on ``cuda:r``: each layout below against the same configuration in
one process on card 0.  A layout passes when every rank's step was
captured in a CUDA graph (the collectives inside it) and replayed, the
backend is NCCL, each rank's flash launches are one a layer, micro-batch
and step (replays count what their capture launched), and the losses
(and for the fp32 configuration the gathered weights) hold phase 22's
limits.  One JSON line a layout: ms a step against one process, the
collectives a rank issued at capture (``comm_stats``), ``nvidia-smi``'s
name and power limit.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

# (name, configuration, mesh, sp, optimizer options) on 4 ranks; a
# 2-rank layout runs twice over an axis no parameter names (``r``)
LAYOUTS = [
    ("dp2_tp2", "gpt2_fp32_2_layers", {"dp": 2, "tp": 2}, False, {}),
    ("dp2_tp2_sp_zero3", "gpt2_fp32_2_layers", {"dp": 2, "tp": 2}, True,
     {"zero": 3}),
    ("dp2_flat_fp32", "gpt2_fp32_2_layers", {"r": 2, "dp": 2}, False,
     {"zero": 2, "grad_comm": "fp32", "flat_state": True}),
    ("dp2_tp2_sp_zero2", "gpt2_small_bf16", {"dp": 2, "tp": 2}, True,
     {"zero": 2}),
    ("tp4_sp", "gpt2_small_bf16", {"tp": 4}, True, {}),
    ("tp4_sp", "llama3_8b_2_layers", {"tp": 4}, True, {}),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    import chip_smoke as c
    if c.torch.cuda.device_count() < a.ranks:
        print(f"mesh_nccl: {a.ranks} ranks need as many cards",
              file=sys.stderr)
        return 2
    c.phase_build()
    c.MESH_RANKS = a.ranks
    cases = [[case, c.mesh_config(name), shape, sp, kw]
             for case, name, shape, sp, kw in LAYOUTS]
    refs, runs = c.mesh_runs(cases, compare={"gpt2_fp32_2_layers"})
    smi = c.smi_line()
    lines, failed = [], []
    for i, (case, name, shape, sp, kw) in enumerate(LAYOUTS):
        ref = refs[name]
        spec = c.mesh_config(name)
        cfg = c.GPTConfig(**spec["cfg"])
        per_rank = [rk[i] for rk in runs]
        r0 = per_rank[0]
        want = c.mesh_flash_want(cfg, spec["seq"], spec["steps"],
                                 spec["micro"])
        gap = max(abs(x - y) for x, y in zip(r0["losses"], ref["losses"]))
        line = {"layout": case, "config": name, "mesh": shape, "sp": sp,
                "opt": kw, "backend": r0["backend"],
                "captured": [r["captured"] for r in per_rank],
                "compile_count": [r["compile_count"] for r in per_rank],
                "losses": r0["losses"], "one_process_losses": ref["losses"],
                "max_loss_gap": gap,
                "ms_per_step": r0["ms_per_step"],
                "one_process_ms_per_step": ref["ms_per_step"],
                "comm_rank0": r0["comm"],
                "flash_rank0": {k: v["launches"]
                                for k, v in r0["flash"].items()},
                "peak_memory_bytes_rank0": r0["peak_memory_bytes"],
                **r0.get("weights", {}), "nvidia_smi": smi}
        ok = r0["backend"] == "nccl" and all(line["captured"]) and \
            all({k: v["launches"] for k, v in r["flash"].items()} == want
                for r in per_rank) and \
            all(r["losses"] == r0["losses"] for r in per_rank)
        if name == "gpt2_fp32_2_layers":
            ok = ok and max(abs(x - y) / abs(y) for x, y in zip(
                r0["losses"], ref["losses"])) <= 1e-4 and \
                r0["weights"]["param_update_rel_diff"] <= 1e-2
        else:
            unit, limit, gaps, held = c.mesh_loss_gaps(name, r0["losses"],
                                                       ref["losses"])
            line["loss_gap"] = {"unit": unit, "limit": limit,
                                "by_step": gaps}
            ok = ok and held
        line["ok"] = ok
        if not ok:
            failed.append(case)
        lines.append(line)
        print(json.dumps(line), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    if failed:
        print(f"mesh_nccl: failed {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
