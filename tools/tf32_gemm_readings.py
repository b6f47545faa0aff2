"""F2's readings (ROADMAP §3): the fp32 training steps with TF32 GEMMs
off and on, on the card.

    python3 tools/tf32_gemm_readings.py [--out FILE] [--steps N] TREE...

For each checkout ``TREE`` (run them as parent, change, change, parent:
``_compare/parent . . _compare/parent``) a fresh process imports that
tree's ``chip_smoke.py``, builds its kernels (a tree whose build
directory lacks them takes the first tree's: the sources hash the same
or they are built), and times with ``torch.backends.cuda.matmul.
allow_tf32`` off and then on: phase 7's Llama-3-8B-widths step (4
layers, seq 4096, global batch 4, bf16 weights whose activations the
LLaMA path promotes to fp32 after layer 0) and phase 17's fp32
BERT-base step (seq 512, batch 32).  Each reading is a new graph,
captured at its first step (the GEMMs a graph replays are chosen when
it is captured), then ``--steps`` replayed steps on a host clock around
a synchronize, with the SM clock and power draw sampled beside them
(``tools/smi.py``), the first step's loss, and ``nvidia-smi``'s name and
power limit.  One JSON line a reading.  No default of the program
changes: the setting is the tool's own.
"""
import argparse
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

READ = r"""
import gc, json, sys, time
sys.path.insert(0, {tree!r})
sys.path.insert(0, {tools!r})
import numpy as np, torch
import chip_smoke as c
from smi import clocks
c.phase_build()
smi = c.smi_line()
steps = {steps}


def timed(step):
    l = float(step()[0])                     # capture
    torch.cuda.synchronize()
    into = {{}}
    times = []
    with clocks(into):
        for _ in range(steps):
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
    return l, times, into


def llama():
    cfg, batch, seq = c.train_config("llama3_8b_4_layers")
    g, ids, labels, model, loss, op = c.build_trainer(cfg, batch, seq,
                                                       "cuda", lr=3e-4)
    x, y = c.seeded_batch(cfg.vocab_size, batch, seq, seed=0)
    return g, lambda: g.run(loss, [loss, op], {{ids: x, labels: y}},
                            num_micro_batches=c.TRAIN_MICRO)


def bert():
    cfg = c.BertConfig()
    g, phs, model, loss, op = c.build_bert(cfg, c.BERT_BATCH, c.BERT_SEQ,
                                           "cuda", c.BERT_LR, False)
    feeds = dict(zip(phs, c.bert_batch(cfg.vocab_size, c.BERT_BATCH,
                                       c.BERT_SEQ)))
    return g, lambda: g.run(loss, [loss, op], feeds,
                            num_micro_batches=c.BERT_MICRO)


for name, build in (("llama3_8b_4_layers", llama), ("bert_base_fp32", bert)):
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        g, step = build()
        l, times, into = timed(step)
        print(json.dumps({{"tree": {tree!r}, "workload": name, "tf32": tf32,
                          "first_loss": l,
                          "ms_per_step": 1e3 * float(np.mean(times)),
                          "step_ms": [1e3 * t for t in times],
                          "captured": g.last_run_captured, **into,
                          "nvidia_smi": smi}}), flush=True)
        del g, step
        gc.collect()
        torch.cuda.empty_cache()
torch.backends.cuda.matmul.allow_tf32 = False
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    built = None
    lines = []
    for tree in a.trees:
        tree = os.path.abspath(tree)
        build = os.path.join(tree, "hetu_tpu_torch", "csrc", "_build")
        if built is not None and not os.path.isdir(build):
            shutil.copytree(built, build)
        p = subprocess.run(
            [sys.executable, "-c", READ.format(tree=tree, tools=HERE,
                                               steps=a.steps)],
            cwd=tree, capture_output=True, text=True, timeout=1500)
        got = [l for l in p.stdout.splitlines() if l.startswith('{"tree"')]
        if p.returncode != 0 or len(got) != 4:
            sys.stderr.write(p.stderr[-4000:])
            raise SystemExit(f"{tree}: exit {p.returncode}")
        built = built or build
        for line in got:
            print(line, flush=True)
            lines.append(line)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "a") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
