"""Phase 19 (b) of ``chip_smoke.py`` over and over in one process.

    python3 tools/graph_grad_repeat.py [--repeats 16] [--out FILE]

on the card.  Builds the port's kernels, then trains GPT-2 small's
widths in bf16 (phase 19's configuration and weights) through 3 GRAD
runs and an UPDATE ``--repeats`` times, alternately captured in CUDA
graphs and eager (``capture.eager()``), each time in a fresh graph, and
holds every result against one Adam step on the eager gradients summed
in the parameters' dtype, as phase 19 (b) does.  One JSON line a repeat:
the largest relative difference of a tensor's update, the three worst
tensors, and the GRAD runs' sums against the summed eager gradients;
then a summary line with ``nvidia-smi``'s name and power limit.  It
looks for a captured step that parts from the eager one now and then.
"""
import argparse
import contextlib
import gc
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=16)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    import numpy as np
    import chip_smoke as c
    if not c.torch.cuda.is_available():
        print("graph_grad_repeat: no CUDA device", file=sys.stderr)
        return 2
    torch, ht = c.torch, c.ht
    c.phase_build()
    cfg = c.GPTConfig(vocab_size=50304, dtype="bfloat16")
    _, init = c.graph_buckets(cfg)
    batches = [c.seeded_batch(cfg.vocab_size, c.GRAPH_GRAD_BATCH,
                              c.GRAPH_SEQ, seed=300 + i)
               for i in range(c.GRAPH_GRAD_RUNS + 1)]
    with ht.graph("define_and_run", create_new=True, device="cuda",
                  seed=0) as rg:
        rids = ht.parallel_placeholder("int32", (c.GRAPH_GRAD_BATCH,
                                                 c.GRAPH_SEQ))
        rlab = ht.parallel_placeholder("int32", (c.GRAPH_GRAD_BATCH,
                                                 c.GRAPH_SEQ))
        rmodel = c.GPTLMHeadModel(cfg)
        rloss = rmodel(rids, rlab)
        xs = [p for _, p in rmodel.named_parameters()]
        grads = ht.gradients(rloss, xs)
    c.load_state(rmodel, init)
    with c.capture.eager():
        runs = [rg.run(grads, feed_dict={rids: x, rlab: y})
                for x, y in batches]
    grad_sum = [v.clone() for v in runs[0]]
    for gv in runs[1:-1]:
        for s, v in zip(grad_sum, gv):
            s.add_(v)
    c.ht.optim.AdamOptimizer(lr=c.GRAPH_LR)._apply_updates(
        rg, xs, [v + s for v, s in zip(runs[-1], grad_sum)])
    want = c.state_numpy(rmodel)
    del runs
    lines = []
    for rep in range(a.repeats):
        mode = "captured" if rep % 2 == 0 else "eager"
        with (c.capture.eager() if mode == "eager"
              else contextlib.nullcontext()):
            g, ids, labels, model, loss, op = c.graph_trainer(
                cfg, init, c.GRAPH_GRAD_BATCH)
            for i, (x, y) in enumerate(batches):
                g.run(loss, [loss, op], {ids: x, labels: y},
                      run_level="grad" if i < c.GRAPH_GRAD_RUNS
                      else "update")
                if i == c.GRAPH_GRAD_RUNS - 1:
                    accum = [g._grad_accum.get(p.id)
                             for p in model.parameters()]
                    accum_rel = max(
                        float((u.float() - s.float()).norm()) /
                        max(float(s.float().norm()), 1e-30)
                        for u, s in zip(accum, grad_sum) if u is not None)
                    del accum
        got = c.state_numpy(model)
        rel = {k: float(np.linalg.norm(got[k] - want[k])) /
               max(float(np.linalg.norm(want[k] - init[k])), 1e-30)
               for k in want}
        worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
        lines.append({"repeat": rep, "mode": mode,
                      "update_rel_diff": worst[0][1], "worst": worst,
                      "grad_sum_rel_diff": accum_rel})
        print(json.dumps(lines[-1]), flush=True)
        del g, ids, labels, model, loss, op, got
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"repeats": a.repeats,
               "missed": sum(ln["update_rel_diff"] > 1e-2 for ln in lines),
               "nonzero": sum(ln["update_rel_diff"] > 0 for ln in lines),
               "nvidia_smi": c.smi_line()}
    print(json.dumps(summary), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "a") as f:
            for ln in lines + [summary]:
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
