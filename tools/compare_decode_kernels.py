"""Time the paged attention kernels of several checkouts on one card, in
turns.

    python3 tools/compare_decode_kernels.py [--out FILE] P C C P

Each argument is the root of a checkout of this repository (here P the
parent's, C the change's).  For each, in
order and in a fresh process, with that checkout's kernels built from its
own sources: the ragged kernel (kernel 5) on ``chip_smoke.py``'s phase-3
batch (Llama-3-8B serving shapes, bf16: six decode rows of contexts 1 to
4096 and a 512-token chunk over 3000 positions), whole and with its
decode rows and its chunk row apart; the paged decode kernel (kernel 7) on
phase 10's batches 8 and 64 in bf16 and fp32; each timed with CUDA events
around the wrapper's calls (``ms``, host work included) and around the
replays of a CUDA graph of one call (``device_ms``), and the host's time
a call enqueued back to back (``host_us``), after a check against the
plain version; then phase 4 (the serving engine at Llama-3-8B widths,
with the step profile that reads kernel 5's share of device busy time)
and phase 8 (2-layer fp32 training, card against CPU), as that
checkout's own ``chip_smoke.py`` defines them.  Standard output gets
one summary line per run, with the card's name and power limit; with
``--out FILE`` every JSON line also goes to FILE, with the checkout
beside it.  Needs a CUDA device.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

# phase 3's batch (chip_smoke.RAGGED_*)
Q_LENS = [1, 1, 1, 1, 1, 1, 0, 0, 512]
CTX_LENS = [4096, 3001, 1500, 65, 64, 1, 0, 0, 3000]
CU = [0, 1, 2, 3, 4, 5, 6, 7, 8, 520]
NH, KVH, HD, PS, MAX_Q, MAXP = 32, 8, 128, 64, 512, 128


def ragged_batch(torch):
    """Phase 3's batch from seed 0, as ``chip_smoke.ragged_serving_batch``
    builds it."""
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    perm = rng.permutation(np.arange(1, 1024))
    pt = np.zeros((len(Q_LENS), MAXP), np.int32)
    k = 0
    for i, c in enumerate(CTX_LENS):
        need = -(-c // PS)
        pt[i, :need] = perm[k:k + need]
        k += need
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    q = rnd(CU[-1], NH, HD)
    kp, vp = rnd(1024, PS, KVH, HD), rnd(1024, PS, KVH, HD)

    def i32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    return q, kp, vp, i32(Q_LENS), i32(CU), i32(pt), i32(CTX_LENS)


def host_us(call, torch, n=200) -> float:
    """The host's time a call of ``call`` (the wrapper's Python and its
    launches), enqueued back to back without waiting for the card."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def one(root: str) -> None:
    """The measurements of one checkout, in this process."""
    root = os.path.abspath(root)
    os.chdir(root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    import torch
    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    cs.phase_device()
    ragged, plain = cs.ragged_paged_attention_cuda, \
        cs.ragged_paged_attention_reference
    args = ragged_batch(torch)
    got = ragged(*args, max_q=MAX_Q)
    torch.cuda.synchronize()
    ratios, err = cs.bf16_agreement(got, plain(*args, max_q=MAX_Q), CU,
                                    Q_LENS)
    out = {"err_over_limit": max(ratios), "max_abs_err": err}
    for part, keep in (("whole", lambda i: True),
                       ("decode_rows", lambda i: i < 8),
                       ("chunk_row", lambda i: i == 8)):
        ql = torch.tensor([n if keep(i) else 0 for i, n in
                           enumerate(Q_LENS)], dtype=torch.int32,
                          device="cuda")
        pargs = args[:3] + (ql,) + args[4:]
        call = lambda: ragged(*pargs, max_q=MAX_Q)  # noqa: E731
        out[part] = {"ms": cs.cuda_time_ms(call, warmup=3, iters=20),
                     "device_ms": cs.graph_ms(call, iters=20),
                     "host_us": host_us(call, torch)}
    print(json.dumps({"phase": "compare_ragged", **out}), flush=True)
    paged = {}
    for batch in (8, 64):
        for name, dtype in (("bf16", torch.bfloat16),
                            ("fp32", torch.float32)):
            pargs, seq_lens, _ = cs.paged_inputs(batch, dtype, seed=batch)
            got = cs.paged_attention_cuda(*pargs)
            torch.cuda.synchronize()
            ratio = cs.paged_agreement(
                got, cs.paged_attention_reference(*pargs), seq_lens,
                dtype)[0]
            call = lambda: cs.paged_attention_cuda(*pargs)  # noqa: E731
            paged[f"batch{batch}/{name}"] = {
                "err_over_limit": ratio,
                "ms": cs.cuda_time_ms(call, warmup=3, iters=20),
                "device_ms": cs.graph_ms(call, iters=20),
                "host_us": host_us(call, torch)}
            del pargs, got
    print(json.dumps({"phase": "compare_paged", **paged}), flush=True)
    del args
    torch.cuda.empty_cache()
    cs.phase_main_path(
        cs.llama3_8b_config(), "main_path",
        "Llama-3-8B widths, random bf16 weights (seed 0)",
        cs.ragged_paged_attention_cuda,
        cs.latent_ragged_paged_attention_cuda)
    cs.phase_train_oracle()


def summary(lines):
    """The numbers the comparison reads, from one run's JSON lines."""
    out = {}
    for obj in lines:
        phase = obj.get("phase")
        if phase == "device":
            out["device"] = obj["nvidia_smi"]
        elif phase in ("compare_ragged", "compare_paged"):
            out[phase] = {k: v for k, v in obj.items() if k != "phase"}
        elif phase == "main_path":
            out["phase4"] = {k: obj[k] for k in (
                "tokens_per_s", "kernel_launches", "unified_steps")}
        elif phase == "train_oracle":
            out["phase8"] = {name: {k: obj[name][k] for k in (
                "loss_rel_diff", "param_update_rel_diff",
                "param_max_abs_diff")}
                for name in ("llama_widths", "gpt2_widths")}
        elif phase == "step_profile":
            out["step_profile"] = {k: obj[k] for k in (
                "device_busy_s", "idle_share", "attention_s",
                "attention_share_of_busy")}
    return out


def main(roots, out=None, script=__file__, summarize=summary) -> int:
    """Runs ``script --one ROOT`` for each root in turn (``script``'s own
    measurements, ``summarize`` its summary of them); every JSON line goes
    to ``out`` with the run and checkout beside it."""
    failed = 0
    with open(out or os.devnull, "a") as log:
        for run, root in enumerate(roots):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(script), "--one", root],
                capture_output=True, text=True)
            lines = []
            for text in proc.stdout.splitlines():
                try:
                    obj = json.loads(text)
                except ValueError:
                    continue
                lines.append(obj)
                log.write(json.dumps({"run": run, "checkout": root,
                                      **obj}) + "\n")
            log.flush()
            print(json.dumps({"run": run, "checkout": root,
                              "exit": proc.returncode,
                              **summarize(lines)}), flush=True)
            if proc.returncode:
                failed += 1
                print(proc.stderr[-4000:], file=sys.stderr, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(sys.argv[2])
        sys.exit(0)
    args = sys.argv[1:]
    out = None
    if args[:1] == ["--out"]:
        out, args = args[1], args[2:]
    sys.exit(main(args, out))
