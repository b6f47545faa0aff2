"""How often ``torch.profiler`` loses kernel records of replayed CUDA graphs.

    python3 tools/profile_record_loss.py [--mode plain|warm]
                                         [--seconds 100] [--no-lazy-reinit]

Builds ``chip_smoke.py`` phase 17's BERT-base pre-training step (bf16
autocast, batch 32, seq 512, 2 micro-batches, captured), runs it 6 times,
then profiles windows of 2 replayed steps for ``--seconds``:

- ``plain``: one profiler session a window (CPU and CUDA activities);
- ``warm``: one session of a discarded warm-up window and the read window
  (``schedule(wait=0, warmup=1, active=1)``).

Every window replays the same captured graphs, so every window launches
the same kernels.  Prints one JSON line: the windows, the most common
kernel count, and each window whose count of any kernel differs from the
most common, with the difference by kernel.  ``--no-lazy-reinit`` sets
``DISABLE_CUPTI_LAZY_REINIT=1`` before torch starts.  Run from the
repository root; needs a CUDA device.
"""
import argparse
import collections
import json
import os
import sys
import time

ARGS = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ARGS.add_argument("--mode", choices=("plain", "warm"),
                  default="plain")
ARGS.add_argument("--seconds", type=float, default=100.0)
ARGS.add_argument("--no-lazy-reinit", action="store_true")
OPTS = ARGS.parse_args()
if OPTS.no_lazy_reinit:
    os.environ["DISABLE_CUPTI_LAZY_REINIT"] = "1"

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, schedule  # noqa: E402

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def counts_of(prof):
    return {k: n for _, k, n in cs.device_kernels(prof)}


def main():
    if not torch.cuda.is_available():
        print("profile_record_loss: no CUDA device", file=sys.stderr)
        return 2
    cs.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cs.BertConfig()
    g, phs, _, loss, train_op = cs.build_bert(
        cfg, cs.BERT_BATCH, cs.BERT_SEQ, "cuda", cs.BERT_LR, True)
    feeds = dict(zip(phs, cs.bert_batch(cfg.vocab_size, cs.BERT_BATCH,
                                        cs.BERT_SEQ)))

    def two():
        for _ in range(2):
            g.run(loss, [loss, train_op], feeds,
                  num_micro_batches=cs.BERT_MICRO)

    for _ in range(3):
        two()
    torch.cuda.synchronize()

    def plain():
        with profile(activities=ACTIVITIES) as prof:
            two()
            torch.cuda.synchronize()
        return counts_of(prof)

    def warm():
        got = {}
        with profile(activities=ACTIVITIES,
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: got.update(counts_of(p))) as p:
            for _ in range(2):
                two()
                torch.cuda.synchronize()
                p.step()
        return got

    window = {"plain": plain, "warm": warm}[OPTS.mode]
    wins, t0 = [], time.perf_counter()
    while time.perf_counter() - t0 < OPTS.seconds:
        wins.append(window())
    names = set().union(*wins)
    usual = {k: collections.Counter(w.get(k, 0) for w in wins)
             .most_common(1)[0][0] for k in names}
    lossy = [{"window": i, "kernels": sum(w.values()),
              "diff": {k[:90]: w.get(k, 0) - usual[k] for k in names
                       if w.get(k, 0) != usual[k]}}
             for i, w in enumerate(wins) if any(
                 w.get(k, 0) != usual[k] for k in names)]
    print(json.dumps({
        "mode": OPTS.mode, "no_lazy_reinit": OPTS.no_lazy_reinit,
        "windows": len(wins), "usual_kernels": sum(usual.values()),
        "usual_flash": {k[:90]: n for k, n in usual.items()
                        if "flash_" in k},
        "windows_off_usual": len(lossy), "off_usual": lossy}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
