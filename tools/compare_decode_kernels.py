"""Time the paged attention kernels of several checkouts on one card, in
turns.

    python3 tools/compare_decode_kernels.py [--out FILE] [--only GROUPS]
        P C C P

Each argument is the root of a checkout of this repository (here P the
parent's, C the change's).  For each, in order and in a fresh process,
with that checkout's kernels built from its own sources, the groups of
``--only`` (comma-separated; default all, in this order):

- ``ragged``: the ragged kernel (kernel 5) on ``chip_smoke.py``'s phase-3
  batch (Llama-3-8B serving shapes, bf16: six decode rows of contexts 1
  to 4096 and a 512-token chunk over 3000 positions), whole and with its
  decode rows and its chunk row apart;
- ``paged``: the paged decode kernel (kernel 7) on phase 10's batches 8
  and 64 in bf16 and fp32;
- ``latent``: the latent kernel (kernel 6) on each of phase 9's batches
  (the Llama-3-8B MLA one with bf16 pages; GPT-2 widths with bf16, int8
  and nf4 pages), whole and, where the batch has both, its decode rows
  and its chunk row apart, with the route the checkout takes;
- ``phase4``: the serving engine at Llama-3-8B widths, with the step
  profile that reads kernel 5's share of device busy time;
- ``phase8``: 2-layer fp32 training, card against CPU;
- ``phase11``: the MLA serving engine at Llama-3-8B widths, with the step
  profile that reads kernel 6's share;

the phases as that checkout's own ``chip_smoke.py`` defines them.  Each
kernel reading is checked against the plain version and timed with CUDA
events around the wrapper's calls (``ms``, host work included), around
the replays of a CUDA graph of one call (``device_ms``) and by the
host's time a call enqueued back to back (``host_us``), with the SM clock
and power draw ``nvidia-smi`` sampled during it beside it (``tools/
smi.py``).  Standard output gets one summary line per run, with the
card's name and power limit; with ``--out FILE`` every JSON line also
goes to FILE, with the checkout beside it.  Needs a CUDA device.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

from smi import clocks

GROUPS = ("ragged", "paged", "latent", "phase4", "phase8", "phase11")

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


def latent_batch(cs, torch, shape, seed=0):
    """A batch of phase 9 (``shape``: an entry of
    ``chip_smoke.LATENT_CASES``) from ``seed``, as
    ``chip_smoke.latent_case`` builds it: the arguments of the latent
    wrappers and their keywords."""
    nh, d_c, d_r, hd, ctx_lens, maxp, num_pages, kind = shape
    ps = 64
    dev = torch.device("cuda")
    rng = np.random.RandomState(seed)
    perm = rng.permutation(np.arange(1, num_pages))
    pt = np.zeros((len(cs.LATENT_Q_LENS), maxp), np.int32)
    k = 0
    for i, c in enumerate(ctx_lens):
        need = -(-c // ps)
        pt[i, :need] = perm[k:k + need]
        k += need
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    q = rnd(cs.LATENT_CU[-1], nh, d_c + d_r)
    lat = rnd(num_pages, ps, 1, d_c)
    quant = None if kind == "bf16" else kind
    r_pages = scale_pages = None
    if quant:
        c_pages, scale_pages = cs.quantize_rows(lat, quant)
    else:
        c_pages = lat.bfloat16()
        if d_r:
            r_pages = rnd(num_pages, ps, 1, d_r).bfloat16()
    kw = dict(max_q=512, softmax_scale=(hd + d_r) ** -0.5,
              scale_pages=scale_pages, quant=quant, latent_dim=d_c)

    def i32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    return [q, c_pages, r_pages, i32(cs.LATENT_Q_LENS), i32(cs.LATENT_CU),
            i32(pt), i32(ctx_lens)], kw


def latent_readings(cs, torch):
    """Kernel 6 on every batch of phase 9: the gate's reading against the
    plain version, then the whole call and its parts."""
    kernel = cs.latent_ragged_paged_attention_cuda
    route = getattr(cs, "latent_route", None)
    out = {}
    for name, shape in cs.LATENT_CASES.items():
        args, kw = latent_batch(cs, torch, shape)
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        want = cs.latent_ragged_paged_attention_reference(*args, **kw)
        real = torch.zeros(got.shape[0], dtype=torch.bool, device="cuda")
        for i, n in enumerate(cs.LATENT_Q_LENS):
            real[cs.LATENT_CU[i]:cs.LATENT_CU[i] + n] = True
        ratio = ((got - want).abs() / (cs.PAGED_FP32_TOL * (
            1 + want.abs())))[real].max().item()
        res = {"route": route(kw["quant"], args[1].dtype, shape[1], shape[2],
                              args[1].shape[1], len(cs.LATENT_Q_LENS))
               if route else "mma.sync", "err_over_limit": ratio}
        parts = (("whole", lambda i: True),)
        if name.startswith("llama"):
            parts += (("decode_rows", lambda i: i < 8),
                      ("chunk_row", lambda i: i == 8))
        for part, keep in parts:
            ql = torch.tensor([n if keep(i) else 0 for i, n in
                               enumerate(cs.LATENT_Q_LENS)],
                              dtype=torch.int32, device="cuda")
            pargs = args[:3] + [ql] + args[4:]
            call = lambda: kernel(*pargs, **kw)  # noqa: E731
            r = {}
            with clocks(r, busy=lambda: (call(), torch.cuda.synchronize())):
                r.update(ms=cs.cuda_time_ms(call, warmup=3, iters=20),
                         device_ms=cs.graph_ms(call, iters=20),
                         host_us=host_us(call, torch))
            res[part] = r
        out[name] = res
        del args, got, want
        torch.cuda.empty_cache()
    return out


def one(root: str, groups=GROUPS) -> None:
    """The measurements of one checkout, in this process."""
    root = os.path.abspath(root)
    os.chdir(root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    import torch
    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    cs.phase_device()
    if "ragged" in groups:
        ragged_readings(cs, torch)
    if "paged" in groups:
        paged_readings(cs, torch)
    if "latent" in groups:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps({"phase": "compare_latent",
                          **latent_readings(cs, torch)}), flush=True)
    if "phase4" in groups:
        cs.phase_main_path(
            cs.llama3_8b_config(), "main_path",
            "Llama-3-8B widths, random bf16 weights (seed 0)",
            cs.ragged_paged_attention_cuda,
            cs.latent_ragged_paged_attention_cuda)
    if "phase8" in groups:
        cs.phase_train_oracle()
    if "phase11" in groups:
        r = {}
        with clocks(r):
            cs.phase_main_path(
                cs.mla_config(cs.llama3_8b_config(), kv_latent_dim=512,
                              kv_rope_dim=64), "mla_main_path",
                "Llama-3-8B widths in the MLA layout (kv_latent_dim 512, "
                "kv_rope_dim 64), random bf16 weights (seed 0)",
                cs.latent_ragged_paged_attention_cuda,
                cs.ragged_paged_attention_cuda)
        print(json.dumps({"phase": "phase11_clocks", **r}), flush=True)


def ragged_readings(cs, torch):
    """Kernel 5 on phase 3's batch, whole and by part."""
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


def paged_readings(cs, torch):
    """Kernel 7 on phase 10's batches."""
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
    torch.cuda.empty_cache()


def summary(lines):
    """The numbers the comparison reads, from one run's JSON lines."""
    out = {}
    for obj in lines:
        phase = obj.get("phase")
        if phase == "device":
            out["device"] = obj["nvidia_smi"]
        elif phase in ("compare_ragged", "compare_paged", "compare_latent",
                       "phase11_clocks"):
            out[phase] = {k: v for k, v in obj.items() if k != "phase"}
        elif phase in ("main_path", "mla_main_path"):
            out["phase4" if phase == "main_path" else "phase11"] = {
                k: obj.get(k) for k in (
                    "tokens_per_s", "ttft_p50_s", "kernel_launches",
                    "wgmma_launches", "unified_steps")}
        elif phase == "train_oracle":
            out["phase8"] = {name: {k: obj[name][k] for k in (
                "loss_rel_diff", "param_update_rel_diff",
                "param_max_abs_diff")}
                for name in ("llama_widths", "gpt2_widths")}
        elif phase == "step_profile":
            of = "phase4" if obj.get("of") == "main_path" else "phase11"
            out[f"{of}_step_profile"] = {k: obj.get(k) for k in (
                "device_busy_s", "unprofiled_wall_s", "idle_share",
                "attention_s", "attention_share_of_busy", "top")}
    return out


def main(roots, out=None, script=__file__, summarize=summary,
         extra=()) -> int:
    """Runs ``script --one ROOT [extra]`` for each root in turn
    (``script``'s own measurements, ``summarize`` its summary of them);
    every JSON line goes to ``out`` with the run and checkout beside
    it."""
    failed = 0
    with open(out or os.devnull, "a") as log:
        for run, root in enumerate(roots):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(script), "--one", root,
                 *extra], capture_output=True, text=True)
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
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--one":
        one(sys.argv[2], sys.argv[3].split(",") if len(sys.argv) == 4
            else GROUPS)
        sys.exit(0)
    args = sys.argv[1:]
    out, only = None, ",".join(GROUPS)
    while args[:1] in (["--out"], ["--only"]):
        if args[0] == "--out":
            out = args[1]
        else:
            only = args[1]
        args = args[2:]
    unknown = set(only.split(",")) - set(GROUPS)
    if unknown:
        sys.exit(f"unknown groups {sorted(unknown)}; known: {GROUPS}")
    sys.exit(main(args, out, extra=(only,)))
