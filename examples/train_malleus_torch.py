"""Malleus end-to-end on the PyTorch port: elastic training with
straggler injection, profiling, re-solving, and live strategy hot-switch
(counterpart of ``examples/train_malleus.py``).

Train a LLaMA-style GPT under an initial ``{"dp": n // 2, "tp": 2}``
layout over ``n`` rank processes, inject a synthetic straggler workload
mid-run, profile the ranks' step ratios, re-solve the hetero layout with
the ``StrategyModel``, and hot-switch the parameters and Adam's states
to the new layout (``DefineAndRunGraph.switch_strategy``) without losing
training state.  In the port a device of the solver is a rank: the new
mesh is laid over the ranks in the plan's device order.

Self-checking accuracy gate (the reference's ``test_accuracy``): the
loss stream must be continuous across the switch — the first loss after
the switch may not regress by more than 10 % of the last loss before it,
and the final loss must be below the initial one.

``main(argv)`` launches ``--ranks`` processes of this script through the
port's ``rpc.Launcher`` (on one card they share it over gloo; on the CPU
with ``--device cpu``), each joins by ``rpc.distributed_init``, and rank
0's readings come back: losses before and after, the measured ratios, the
strategy, the switch history and its flash-attention launches.
``--calibrate`` needs the planner (ROADMAP queue 1 item 16) and raises
``NotImplementedError``.

Run:
  python examples/train_malleus_torch.py                # 4 ranks, the card
  python examples/train_malleus_torch.py --device cpu   # 4 gloo CPU ranks
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

ENV_RESULT = "HETU_MALLEUS_RESULT"


def parse_args(argv):
    p = argparse.ArgumentParser(description="Malleus elastic pretraining")
    p.add_argument("--vocab-size", type=int, default=256)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=32)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--switch-at", type=int, default=6)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--calibrate", action="store_true",
                   help="measure comm/compute constants first "
                        "(profile_hardware) instead of defaults")
    p.add_argument("--straggle", type=float, default=3.0,
                   help="slowdown ratio injected on device (rank) 0")
    p.add_argument("--ranks", type=int, default=4,
                   help="rank processes (the solver's devices)")
    p.add_argument("--device", default="cuda",
                   help="cuda (ranks share the card over gloo) or cpu")
    p.add_argument("--launch-timeout", type=float, default=600.0,
                   help="seconds the launched ranks may run")
    return p.parse_args(argv)


def flash_launches() -> dict:
    """This rank's flash-attention kernel launches so far, by wrapper and
    route (0 on the CPU, where the plain versions run)."""
    from hetu_tpu_torch.ops import flash_attention as fa
    out = {}
    for name in ("fwd", "bwd_fused", "bwd_dq", "bwd_dkv"):
        fn = getattr(fa, f"flash_{name}_cuda")
        out[f"flash_{name}"] = {"launches": fn.launches,
                                "wgmma": fn.wgmma_launches,
                                "3xtf32": fn.tf32_launches,
                                "tensor_core": fn.tensor_core_launches}
    return out


def launch(argv, ranks: int, timeout: float) -> dict:
    """Runs this script as ``ranks`` processes through the port's
    launcher; rank 0's readings."""
    from hetu_tpu_torch.rpc import Launcher
    fd, out = tempfile.mkstemp(prefix="train_malleus_", suffix=".json")
    os.close(fd)
    try:
        with Launcher([sys.executable, os.path.abspath(__file__)] +
                      list(argv), num_workers=ranks,
                      env={ENV_RESULT: out}) as lau:
            ok = lau.monitor(poll=0.1, timeout=timeout)
        if ok != ranks:
            raise RuntimeError(f"{ranks - ok} of {ranks} ranks failed: "
                               f"{lau.events}")
        with open(out) as f:
            return json.load(f)
    finally:
        os.remove(out)


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.calibrate:
        raise NotImplementedError(
            "--calibrate (planner.profile_hardware) is ported in ROADMAP "
            "queue 1 item 16 (planner)")
    if args.steps <= args.switch_at + 2:
        raise SystemExit(
            f"--steps ({args.steps}) must exceed --switch-at + 2 "
            f"({args.switch_at + 2}): the run needs profile steps and at "
            "least one post-switch step for the accuracy gate")
    n = args.ranks
    if n < 2 or n % 2:
        raise SystemExit(f"--ranks ({n}) must be even: the run starts on "
                         f"{{'dp': n // 2, 'tp': 2}}")
    from hetu_tpu_torch.rpc.launcher import ENV_COORD
    if ENV_COORD not in os.environ:
        return launch(argv, n, args.launch_timeout)

    import hetu_tpu_torch as ht
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.elastic import (Straggler, StragglerWorkload,
                                        StrategyModel, Trainer)
    from hetu_tpu_torch.models import GPTLMHeadModel, llama_config
    from hetu_tpu_torch.parallel import P, create_mesh
    from hetu_tpu_torch.rpc import distributed_init

    client = distributed_init(os.environ[ENV_COORD], n, device=args.device)
    rank = client.rank
    mesh = create_mesh({"dp": n // 2, "tp": 2}, device=args.device)
    solver = StrategyModel(num_devices=n, num_layers=args.layers)
    cfg = llama_config(vocab_size=args.vocab_size, hidden_size=args.hidden,
                       num_layers=args.layers, num_heads=args.heads,
                       max_seq_len=args.seq_len, sp=False)
    with ht.graph("define_and_run", create_new=True, mesh=mesh,
                  seed=0) as g:
        ids = ht.parallel_placeholder(
            "int32", (args.global_batch, args.seq_len),
            pspec=P("dp", None), name="ids")
        lbl = ht.parallel_placeholder(
            "int32", (args.global_batch, args.seq_len),
            pspec=P("dp", None), name="lbl")
        model = GPTLMHeadModel(cfg)
        loss = model(ids, lbl)
        opt = optim.AdamOptimizer(lr=args.lr)
        train_op = opt.minimize(loss)

        # two fixed batches cycled (memorizable corpus -> the loss can
        # actually fall, which the accuracy gate below requires)
        batches = []
        for b in range(2):
            I = np.random.RandomState(b).randint(
                0, args.vocab_size,
                (args.global_batch, args.seq_len)).astype(np.int32)
            batches.append({ids: I, lbl: np.roll(I, -1, 1)})

        def data_provider(step):
            return batches[step % len(batches)]

        straggler = Straggler(n)
        trainer = Trainer(g, loss, train_op, opt, data_provider, solver,
                          straggler=straggler, switch_threshold=0.02)

        # phase 1: homogeneous layout
        pre = trainer.train_steps(args.switch_at)
        say = print if rank == 0 else (lambda *a, **k: None)
        say("pre-switch losses:", [round(x, 4) for x in pre])

        # inject a straggler (reference test_straggler_workload.py) and
        # retune from the *measured* profile
        ratios = [args.straggle] + [1.0] * (n - 1)
        straggler.inject(StragglerWorkload(ratios))
        trainer.profile(steps=2)
        measured = straggler.read_profile()
        say("measured straggler ratios:", [round(r, 2) for r in measured])
        launches_before = flash_launches()
        switched = trainer.retune(measured)
        strategy = trainer.current_strategy.describe() \
            if trainer.current_strategy else None
        say("retune -> switched:", switched, "| strategy:", strategy)

        # phase 2: continue training on the (possibly new) layout
        post = trainer.train_steps(args.steps - args.switch_at - 2)
        say("post-switch losses:", [round(x, 4) for x in post])

    # -- accuracy gates (reference examples/malleus/test_accuracy.py)
    all_losses = pre + post
    assert all(np.isfinite(all_losses)), all_losses
    # continuity: first post-switch loss must not regress vs the last
    # pre-switch loss by more than 10% of its magnitude
    assert post[0] <= pre[-1] + 0.1 * abs(pre[-1]), (pre[-1], post[0])
    assert all_losses[-1] < all_losses[0], all_losses
    hist = trainer.history
    say("switch history:", json.dumps(hist))
    say(f"malleus e2e OK: {all_losses[0]:.4f} -> {all_losses[-1]:.4f} | "
        f"switches recorded: {len(hist)}")
    result = {"pre": pre, "post": post, "ratios": measured,
              "flash_launches": {"before_switch": launches_before,
                                 "after_switch": flash_launches()},
              "switched": bool(switched), "strategy": strategy,
              "mesh": dict(g.mesh.shape), "ranks": list(g.mesh.ranks),
              "history": hist, "num_strategy": g.num_strategy}
    import torch.distributed as dist
    if rank == 0 and os.environ.get(ENV_RESULT):
        with open(os.environ[ENV_RESULT], "w") as f:
            json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()
    client.exit()
    return result


if __name__ == "__main__":
    main()
