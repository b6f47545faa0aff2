"""Time the split-KV decode core at fixed slice counts on one card.

    python3 tools/sweep_decode_splits.py

The paged decode kernel (kernel 7) on phase 10's batch 8 in bf16, on 8
requests of 4096 positions and on one request of 4096 (Llama-3-8B shapes:
nh 32, kvh 8, hd 128, page 64), and the ragged kernel (kernel 5) on the
decode rows of ``chip_smoke.py``'s phase-3 batch (max_q 512 and 1), each
with the wrappers' slice count replaced by 1 to 64 (what
``ops.kv_split.core_splits`` would pick is one of them).  Per line: the
error over the bf16 gate (paged), the device time of one call by CUDA-graph
replay and the CUDA kernels' times under ``torch.profiler``.  Run from the
repository root; needs a CUDA device.
"""
import json
import os
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
import hetu_tpu_torch.ops.paged_attention as pa  # noqa: E402
import hetu_tpu_torch.ops.ragged_paged_attention as rpa  # noqa: E402


def kernel_us(fn, n=20):
    """Each CUDA kernel's mean device time over ``n`` calls of ``fn``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:40]: e.self_device_time_total / n
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total}


def uniform_batch(seq_lens):
    """Requests of ``seq_lens`` at Llama-3-8B's shapes, bf16, seed 0."""
    nh, kvh, hd, ps, maxp = 32, 8, 128, 64, 64
    rng = np.random.RandomState(0)
    num_pages = 1 + sum(-(-c // ps) for c in seq_lens)
    perm = rng.permutation(np.arange(1, num_pages))
    pt = np.zeros((len(seq_lens), maxp), np.int32)
    k = 0
    for i, c in enumerate(seq_lens):
        need = -(-c // ps)
        pt[i, :need] = perm[k:k + need]
        k += need
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    return (rnd(len(seq_lens), nh, hd), rnd(num_pages, ps, kvh, hd),
            rnd(num_pages, ps, kvh, hd), torch.from_numpy(pt).cuda(),
            torch.tensor(seq_lens, dtype=torch.int32, device="cuda"))


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_decode_splits: no CUDA device", file=sys.stderr)
        return 2
    counts = (1, 2, 4, 8, 16, 32, 64)
    batches = {"batch8": cs.paged_inputs(8, torch.bfloat16, seed=8)[:2],
               "uniform8x4096": (uniform_batch([4096] * 8), [4096] * 8),
               "one4096": (uniform_batch([4096]), [4096])}
    chosen = pa.core_splits
    for name, (args, seq_lens) in batches.items():
        for n in counts:
            pa.core_splits = lambda *a, n=n: n
            got = pa.paged_attention_cuda(*args)
            torch.cuda.synchronize()
            ratio = cs.paged_agreement(
                got, pa.paged_attention_reference(*args), list(seq_lens),
                torch.bfloat16)[0]
            call = lambda: pa.paged_attention_cuda(*args)  # noqa: E731
            print(json.dumps({"case": name, "n_splits": n, "ratio": ratio,
                              "graph_ms": cs.graph_ms(call, iters=20),
                              "kernels_us": kernel_us(call)}), flush=True)
    pa.core_splits = chosen
    args, _, _ = cs.ragged_serving_batch()
    decode = torch.tensor([n if n == 1 else 0 for n in cs.RAGGED_Q_LENS],
                          dtype=torch.int32, device="cuda")
    dargs = args[:3] + (decode,) + args[4:]
    chosen = rpa.core_splits
    for n in (4, 8, 15, 32, 64):
        rpa.core_splits = lambda *a, n=n: n
        for mq in (512, 1):
            call = lambda: rpa.ragged_paged_attention_cuda(  # noqa: E731
                *dargs, max_q=mq)
            print(json.dumps({"case": "ragged_decode", "n_splits": n,
                              "max_q": mq,
                              "graph_ms": cs.graph_ms(call, iters=20),
                              "kernels_us": kernel_us(call)}), flush=True)
    rpa.core_splits = chosen
    return 0


if __name__ == "__main__":
    sys.exit(main())
