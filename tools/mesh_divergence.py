"""How far the mesh layouts' training parts from one process, on the card.

    python3 tools/mesh_divergence.py [--config gpt2_small_bf16]
        [--layouts dp2,dp2_zero2,tp2,tp2_sp] [--layers N] [--steps N]
        [--out FILE]

Builds the port's kernels, trains one configuration of ``chip_smoke.py``
phase 22 (``mesh_config``: ``gpt2_fp32_2_layers``, ``gpt2_small_bf16``
or ``llama3_8b_2_layers``; depth and steps may be cut) in one process
and on 2 ranks of the one card for each layout, from the same seed-0
weights on the same batch, and prints one JSON line a layout: the
per-step losses of both, their largest gap, and the gathered weights'
largest difference from the one-process run's with the update rule of
phase 8 (each tensor's update against the one-process update), beside
``nvidia-smi``'s name and power limit.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

LAYOUTS = {"dp2": ({"dp": 2}, False, {}),
           "dp2_zero1": ({"dp": 2}, False, {"zero": 1}),
           "dp2_zero2": ({"dp": 2}, False, {"zero": 2}),
           "dp2_zero3": ({"dp": 2}, False, {"zero": 3}),
           "dp2_flat_fp32": ({"dp": 2}, False, {"zero": 2,
                                                "grad_comm": "fp32",
                                                "flat_state": True}),
           "tp2": ({"tp": 2}, False, {}),
           "tp2_sp": ({"tp": 2}, True, {})}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="gpt2_small_bf16")
    ap.add_argument("--layouts", default="dp2,dp2_zero2,tp2,tp2_sp")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    import chip_smoke as c
    if not c.torch.cuda.is_available():
        print("mesh_divergence: no CUDA device", file=sys.stderr)
        return 2
    c.phase_build()
    spec = c.mesh_config(a.config)
    if a.layers:
        spec["cfg"]["num_layers"] = a.layers
    if a.steps:
        spec["steps"] = a.steps
    names = a.layouts.split(",")
    cases = [[n, spec, *LAYOUTS[n]] for n in names]
    refs, runs = c.mesh_runs(cases, compare={a.config})
    ref = refs[a.config]
    smi = c.smi_line()
    lines = []
    for i, n in enumerate(names):
        r0 = runs[0][i]
        lines.append({
            "layout": n, "config": a.config,
            "layers": spec["cfg"]["num_layers"], "dtype": spec["cfg"]["dtype"],
            "losses": r0["losses"], "one_process_losses": ref["losses"],
            "max_loss_gap": max(abs(x - y) for x, y in
                                zip(r0["losses"], ref["losses"])),
            "loss_bf16_steps": [c.bf16_steps(x, y) for x, y in
                                zip(r0["losses"], ref["losses"])],
            "loss_rel_gaps": [abs(x - y) / abs(y) for x, y in
                              zip(r0["losses"], ref["losses"])],
            **r0["weights"], "ms_per_step": r0["ms_per_step"],
            "one_process_ms_per_step": ref["ms_per_step"],
            "nvidia_smi": smi})
        print(json.dumps(lines[-1]), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
