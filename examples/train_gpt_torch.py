"""GPT/LLaMA pre-training entry point of the PyTorch/CUDA port.

The port's counterpart of ``examples/train_gpt.py``, with the same
arguments: synthetic tokens by default (``--data`` for a token ``.npy``),
the prefetching dataloader over its native core, micro-batched training
on a define-and-run graph (captured once in a CUDA graph on the card),
``--save``/``--load`` through ``utils.checkpoint.save_model`` /
``load_model``, and the same log line.  ``--device`` (default ``cuda``)
picks the device.  As in the JAX script the loader takes its native core
when it builds and its python path otherwise; ``main`` reports which.
The parallel layouts, tracing and the planner come with later slices:
their flags raise ``NotImplementedError`` naming the ROADMAP item.

On the CPU (tiny widths)::

  python examples/train_gpt_torch.py --device cpu --steps 4 --hidden 64 \\
      --layers 2 --heads 4 --seq-len 32 --vocab-size 256 --global-batch 4

On the card, GPT-2 small's widths (the defaults)::

  python examples/train_gpt_torch.py --bf16 --global-batch 8 --steps 20

``main(argv)`` runs the loop and returns its readings (losses, ms/step,
tokens/s, peak memory, the loader used), so scripts and tests can call
it.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GPT/LLaMA pretraining "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--model", choices=["gpt", "llama"], default="gpt")
    p.add_argument("--vocab-size", type=int, default=50304)
    p.add_argument("--hidden", type=int, default=768)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--seq-len", type=int, default=1024)
    # parallel layout
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--pp", type=int, default=1, help="pipeline stages")
    p.add_argument("--sp", action="store_true", help="sequence parallel")
    p.add_argument("--grad-comm", choices=["fp32", "bf16", "int8"],
                   default=None,
                   help="explicit coalesced gradient sync transport")
    p.add_argument("--flat-state", action="store_true",
                   help="flat dp-sharded optimizer state")
    p.add_argument("--zero", type=int, default=0, choices=[0, 1, 2, 3],
                   help="ZeRO level")
    p.add_argument("--ds-config", type=str, default=None,
                   help="ds_parallel_config JSON path")
    p.add_argument("--auto-parallel", action="store_true",
                   help="let the planner pick the layout")
    p.add_argument("--calibrate", action="store_true",
                   help="with --auto-parallel: calibrate the planner")
    # training
    p.add_argument("--global-batch", type=int, default=16)
    p.add_argument("--micro-batch", type=int, default=None)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--data", type=str, default=None,
                   help="token .npy file; synthetic data if omitted")
    p.add_argument("--save", type=str, default=None,
                   help="safetensors file the weights are saved to at the "
                        "end")
    p.add_argument("--load", type=str, default=None)
    p.add_argument("--log-every", type=int, default=5)
    p.add_argument("--trace-out", type=str, default=None,
                   help="trace the run (ported with the tracing slice)")
    # the port's own
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def check_supported(args) -> None:
    """Refuses, by name, the flags of slices still to be ported."""
    later = {"items 10-14 (the multi-GPU mesh)": [
        ("--dp", args.dp > 1), ("--tp", args.tp > 1), ("--pp", args.pp > 1),
        ("--sp", args.sp), ("--grad-comm", args.grad_comm is not None),
        ("--flat-state", args.flat_state), ("--zero", args.zero > 0),
        ("--ds-config", args.ds_config is not None)],
        "item 16 (the planner)": [("--auto-parallel", args.auto_parallel),
                                  ("--calibrate", args.calibrate)],
        "item 15 (tracing)": [("--trace-out", args.trace_out is not None)]}
    for item, flags in later.items():
        for flag, used in flags:
            if used:
                raise NotImplementedError(
                    f"{flag} is ported with ROADMAP queue 1 {item}")


def tput_fmt(tokens_per_s: float) -> str:
    if tokens_per_s >= 1e6:
        return f"{tokens_per_s / 1e6:.2f}M tok/s"
    return f"{tokens_per_s / 1e3:.1f}k tok/s"


def main(argv=None) -> dict:
    args = parse_args(argv)
    check_supported(args)
    import torch
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.data import Dataloader, GPTSeqDataset
    from hetu_tpu_torch.graph import RunLevel
    from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel, llama_config
    from hetu_tpu_torch.utils import (StepProfiler, device_memory_stats,
                                      get_logger)
    from hetu_tpu_torch.utils.checkpoint import load_model, save_model

    log = get_logger("train_gpt")
    dev = ht.resolve_device(args.device)
    mk = llama_config if args.model == "llama" else GPTConfig
    cfg = mk(vocab_size=args.vocab_size, hidden_size=args.hidden,
             num_layers=args.layers, num_heads=args.heads,
             max_seq_len=args.seq_len, sp=False,
             dtype="bfloat16" if args.bf16 else "float32")
    micro = args.micro_batch or args.global_batch
    num_micro = max(1, args.global_batch // micro)

    # data: token stream -> fixed windows through the prefetching loader
    if args.data:
        tokens = np.load(args.data)
    else:
        rng = np.random.RandomState(0)
        tokens = rng.randint(0, args.vocab_size,
                             args.global_batch * args.seq_len * 64)
    ds = GPTSeqDataset(tokens, seq_len=args.seq_len)
    loader = Dataloader(ds, batch_size=args.global_batch, shuffle=True)

    batch_shape = (args.global_batch, args.seq_len)
    with ht.graph("define_and_run", create_new=True, device=dev,
                  seed=0) as g:
        ids = ht.parallel_placeholder("int32", batch_shape,
                                      name="input_ids")
        labels = ht.parallel_placeholder("int32", batch_shape, name="labels")
        model = GPTLMHeadModel(cfg)
        loss = model(ids, labels)
        train_op = optim.AdamOptimizer(lr=args.lr).minimize(loss)
    if args.load:
        load_model(model, args.load)
        log.info("resumed from %s", args.load)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sp_prof = StepProfiler(warmup=2)
    losses, first = [], None
    step = 0
    while step < args.steps:
        for batch in loader:
            if step >= args.steps:
                break
            if isinstance(batch, tuple):   # python loader
                x, y = batch
            else:                          # native matrix layout
                x, y = batch[:, :args.seq_len], batch[:, args.seq_len:]
            if first is None:
                first = (x, y)
            with sp_prof:
                out = g.run(loss, [loss, train_op], {ids: x, labels: y},
                            num_micro_batches=num_micro)
            losses.append(out[0])
            step += 1
            if step % args.log_every == 0 or step == args.steps:
                st = sp_prof.stats()
                tput = (args.global_batch * args.seq_len
                        / st["mean"]) if st["mean"] else 0.0
                print(f"step {step:5d} | loss {float(out[0]):.4f} | "
                      f"{st['mean'] * 1e3:.1f} ms/step | {tput_fmt(tput)}")
    st = sp_prof.stats()
    result = {
        "steps": step, "losses": [float(v) for v in losses],
        "ms_per_step": st["mean"] * 1e3,
        "tokens_per_s": (args.global_batch * args.seq_len / st["mean"])
        if st["mean"] else 0.0,
        "timed_steps": st["steps"],
        "peak_memory_bytes": device_memory_stats(dev)["peak_bytes_in_use"],
        "loader": "native" if loader._lib is not None else "python",
        "micro_batches": num_micro, "compile_count": g.compile_count,
        "config": {"model": args.model, "vocab": cfg.vocab_size,
                   "hidden": cfg.hidden_size, "layers": cfg.num_layers,
                   "heads": cfg.num_heads, "seq": args.seq_len,
                   "global_batch": args.global_batch, "dtype": cfg.dtype}}
    if args.save:
        # the saved weights' loss on the run's first batch: what a run
        # resumed from the file sees at its first step
        (l0,) = g.run([loss], feed_dict={ids: first[0], labels: first[1]},
                      num_micro_batches=num_micro,
                      run_level=RunLevel.COMPUTE_ONLY)
        result["saved_first_batch_loss"] = float(l0)
        save_model(model, args.save)
        print(f"saved to {args.save} | loss {float(l0):.4f} on the first "
              f"batch")
    return result


if __name__ == "__main__":
    main()
