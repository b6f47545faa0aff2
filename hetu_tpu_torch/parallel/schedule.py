"""Pipeline schedules — GPipe and PipeDream-Flush (1F1B).

The port's own copy of ``hetu_tpu.parallel.schedule`` (pure Python, so
the port keeps it rather than import the JAX package): per pipeline
stage, the ordered list of forward/backward micro-batch tasks the
executor runs (the reference's ``GenerateGpipeSchedule`` and
``GeneratePipedreamFlushSchedule``, ``executable_graph.cc:1343, :1376``).
The MPMD runtime (:mod:`hetu_tpu_torch.parallel.pipeline_mpmd`) consumes
these task lists: a single controller walks them and enqueues each
stage's work on its device, where CUDA's asynchronous launches give the
overlap.

The property that makes 1F1B 1F1B: the number of *in-flight* micro-batches
(forward done, backward not yet) at stage ``s`` never exceeds ``S - s``
(pipeline depth bound), while GPipe's grows to ``M``.  ``max_in_flight``
computes that bound for any schedule so tests (and the runtime's memory
accounting) can assert it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Literal, Sequence

TaskKind = Literal["F", "B"]


@dataclass(frozen=True)
class Task:
    kind: str           # "F" | "B"
    micro_batch: int

    def __repr__(self) -> str:  # compact: F0, B3
        return f"{self.kind}{self.micro_batch}"


def generate_gpipe_schedule(num_stages: int, num_micro_batches: int,
                            inference: bool = False) -> List[List[Task]]:
    """All forwards, then all backwards (fill/drain).

    Reference ``GenerateGpipeSchedule`` (executable_graph.cc:1343).
    """
    out: List[List[Task]] = []
    for _ in range(num_stages):
        tasks = [Task("F", m) for m in range(num_micro_batches)]
        if not inference:
            tasks += [Task("B", m) for m in range(num_micro_batches)]
        out.append(tasks)
    return out


def generate_pipedream_flush_schedule(num_stages: int,
                                      num_micro_batches: int,
                                      inference: bool = False
                                      ) -> List[List[Task]]:
    """1F1B (PipeDream-Flush): warmup forwards, steady-state alternating
    one-forward-one-backward, cooldown backwards, synchronous flush at the
    end of the step.

    Reference ``GeneratePipedreamFlushSchedule``
    (executable_graph.cc:1376).  Stage ``s`` (0-indexed) runs
    ``min(M, S-1-s)`` warmup forwards, so at most ``S - s`` micro-batches
    are ever in flight.
    """
    S, M = num_stages, num_micro_batches
    if inference:
        return generate_gpipe_schedule(S, M, inference=True)
    out: List[List[Task]] = []
    for s in range(S):
        warmup = min(M, S - 1 - s)
        tasks: List[Task] = [Task("F", m) for m in range(warmup)]
        f, b = warmup, 0
        # steady state: 1F1B
        while f < M:
            tasks.append(Task("F", f))
            f += 1
            tasks.append(Task("B", b))
            b += 1
        # cooldown: drain remaining backwards
        while b < M:
            tasks.append(Task("B", b))
            b += 1
        out.append(tasks)
    return out


def generate_interleaved_1f1b_schedule(num_stages: int,
                                       num_micro_batches: int,
                                       num_chunks: int
                                       ) -> List[List[Task]]:
    """Interleaved 1F1B with virtual pipeline stages (Megatron-LM's
    interleaved schedule; beyond the reference, which has GPipe + plain
    1F1B only).

    Each physical stage ``s`` hosts ``num_chunks`` model chunks; virtual
    stage ``v = chunk * S + s`` forms a depth ``V = S * C`` pipeline
    whose per-physical-stage bubble shrinks ~C-fold: ranks start work on
    chunk 0 of later micro-batches while chunk 1 of earlier ones is
    still in flight.  Returns per-VIRTUAL-stage task lists (length
    ``S * C``) directly consumable by the MPMD runtime with meshes
    repeating with period ``S``.

    The Megatron ordering needs ``M % S == 0``; other M fall back to
    plain 1F1B over the virtual chain (correct, larger warmup).
    """
    S, C, M = num_stages, num_chunks, num_micro_batches
    if C == 1:
        return generate_pipedream_flush_schedule(S, M)
    V = S * C
    if M % S != 0:
        return generate_pipedream_flush_schedule(V, M)

    def f_task(k):  # k-th forward in a rank's interleaved order
        group, within = divmod(k, S * C)
        chunk, m = divmod(within, S)
        return chunk, group * S + m

    def b_task(k):  # chunks drained in reverse order
        group, within = divmod(k, S * C)
        chunk, m = divmod(within, S)
        return C - 1 - chunk, group * S + m

    out: List[List[Task]] = [[] for _ in range(V)]
    total_f = M * C
    for s in range(S):
        warmup = min(total_f, (S - s - 1) * 2 + (C - 1) * S)
        rank_tasks: List[tuple] = []
        f = b = 0
        for _ in range(warmup):
            rank_tasks.append(("F", *f_task(f)))
            f += 1
        while f < total_f:
            rank_tasks.append(("F", *f_task(f)))
            f += 1
            rank_tasks.append(("B", *b_task(b)))
            b += 1
        while b < total_f:
            rank_tasks.append(("B", *b_task(b)))
            b += 1
        # project the physical rank's order onto its virtual stages
        # (per-device execution order is preserved by the launch order;
        # cross-stage causality is the runtime's readiness gating)
        for kind, chunk, m in rank_tasks:
            out[chunk * S + s].append(Task(kind, m))
    return out


def p2p_events(schedule: Sequence[Sequence[Task]]
               ) -> List[List[tuple]]:
    """Project a per-stage task schedule onto the stage-boundary P2P
    events each stage issues, in program order.

    Returns, per stage, ``("send"|"recv", "F"|"B", micro_batch,
    peer_stage)`` tuples: a forward task at stage ``s`` first receives
    the activation from ``s-1`` (s > 0), computes, then sends to
    ``s+1`` (s < S-1); a backward task receives the output grad from
    ``s+1`` and sends the input grad to ``s-1``.  This is the symbolic
    order the MPMD runtime's ``p2p_log`` tap records at execution time
    (the JAX package's schedule verifier, ROADMAP queue 1 item 18, also
    checks it for cross-rank pairing).
    """
    S = len(schedule)
    out: List[List[tuple]] = []
    for s, tasks in enumerate(schedule):
        ev: List[tuple] = []
        for t in tasks:
            m = t.micro_batch
            if t.kind == "F":
                if s > 0:
                    ev.append(("recv", "F", m, s - 1))
                if s < S - 1:
                    ev.append(("send", "F", m, s + 1))
            else:
                if s < S - 1:
                    ev.append(("recv", "B", m, s + 1))
                if s > 0:
                    ev.append(("send", "B", m, s - 1))
        out.append(ev)
    return out


def max_in_flight(stage_tasks: Sequence[Task]) -> int:
    """Peak number of micro-batches with forward done but backward not —
    the stage's activation-stash high-water mark."""
    live = 0
    peak = 0
    for t in stage_tasks:
        if t.kind == "F":
            live += 1
            peak = max(peak, live)
        else:
            live -= 1
    return peak


def validate_schedule(schedule: Sequence[Sequence[Task]],
                      num_micro_batches: int) -> None:
    """Sanity checks: every stage runs F and B exactly once per
    micro-batch; per-stage B(m) comes after F(m)."""
    for s, tasks in enumerate(schedule):
        seen_f = [False] * num_micro_batches
        seen_b = [False] * num_micro_batches
        for t in tasks:
            if t.kind == "F":
                assert not seen_f[t.micro_batch], (s, t)
                seen_f[t.micro_batch] = True
            else:
                assert seen_f[t.micro_batch], (s, t)
                assert not seen_b[t.micro_batch], (s, t)
                seen_b[t.micro_batch] = True
        assert all(seen_f) and all(seen_b), f"stage {s} incomplete"
