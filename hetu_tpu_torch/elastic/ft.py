"""Fault-tolerant elastic training (counterpart of ``hetu_tpu.elastic.ft``):
survive worker deaths and silent numeric and durability failures.

* **Durable snapshots** -- every ``checkpoint_every`` steps the trainer
  saves the parameters and the optimizer's state (flat ZeRO buffers per
  parameter) as a checksummed generation (``resilience.generations``), so
  a snapshot restores into any dp size.
* **Death detection** -- a :class:`WorkerMonitor`: training workers on the
  ``rpc`` coordinator, each owning an equal slice of the ranks, each
  heartbeating from the process of its first rank; a worker that stops
  heartbeating past the TTL maps to lost ranks.
* **Re-plan and verified restore** -- on a death verdict the trainer
  rebuilds the graph over the survivors (``build_fn(dp, ranks)``),
  restores the newest generation that VERIFIES (falling back past corrupt
  or half-written ones: ``restore_fallbacks``), rewinds to its step and
  trains on; re-run steps replay the same data cursors.
* **Numeric sentry ladder** -- with an optimizer that carries a
  ``NumericSentry``, an anomalous step was already skipped on the device
  with bitwise-zero residue: the trainer burns that data cursor and
  retries the step on fresh data; ``rewind_after`` consecutive anomalies,
  or one loss spike (``rewind_on_loss_spike``), rewind to the last good
  generation, at most ``max_rewinds`` times.

The port is SPMD by process, as ``elastic.Trainer`` is: a device of
the solver is a rank, ``build_fn(dp, ranks)`` builds on ``create_mesh(
{"dp": dp}, ranks=ranks[:dp])`` (a rank outside the mesh holds no
position and takes no step), and every rank of the world runs this loop
and takes the same decision at the same step.  Death verdicts are read
on rank 0 (it hosts the coordinator) and given to every rank through the
world group at a step boundary; every rank of the mesh computes the same
loss and verdict (both reduced over dp), and when the mesh does not span
the world its first rank gives the loop's state to the ranks outside it.
A "dead" worker is a stopped heartbeat, as in the JAX package: its rank
stays in the process world and leaves the mesh.  MTTR (detect to the
first committed step after the recovery) is recorded per recovery in
:attr:`FaultTolerantTrainer.recoveries`; the counters land in
:meth:`FaultTolerantTrainer.metrics_summary` and :meth:`metrics_text`.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..obs.tracer import get_tracer
from ..rpc.coordinator import CoordinatorClient, CoordinatorServer
from ..utils.metrics import make_instrument, render_prometheus
from .strategy import StrategyModel

#: the failure counters the trainer exposes (metrics_summary, Prometheus)
TRAINER_COUNTERS = (
    "sentry_anomalies", "steps_skipped", "rewinds", "restore_fallbacks",
    "emergency_flushes", "checkpoints_written",
    "checkpoint_write_failures", "worker_recoveries",
)


def _world():
    """(rank, world size) of ``torch.distributed``, (0, 1) without it."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _broadcast(obj, src: int):
    """``obj`` of rank ``src`` on every rank of the world (the world
    group; a no-op in one process)."""
    import torch.distributed as dist
    if _world()[1] == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


class WorkerMonitor:
    """Training workers on the rpc liveness plane.

    Worker ``i`` owns ``len(devices) // num_workers`` ranks and heartbeats
    from the process of its first; rank 0 hosts the coordinator (or uses
    ``server``) and reads its TTL verdicts.  Every rank of the world makes
    the monitor and calls its methods in the same order: ``dead_workers``
    and ``wait_for_verdict`` are decided on rank 0 and given to all.
    Killing a worker (chaos ``worker_death``) stops its heartbeat thread;
    the verdict lands once the TTL lapses, as for a crashed host."""

    def __init__(self, num_workers: int, devices: Sequence[Any],
                 ttl: float = 0.5, heartbeat_interval: float = 0.1,
                 server: Optional[CoordinatorServer] = None):
        if num_workers < 1 or len(devices) % num_workers:
            raise ValueError(
                f"{len(devices)} devices do not split over "
                f"{num_workers} workers")
        self.devices = list(devices)
        self.num_workers = int(num_workers)
        self.per_worker = len(devices) // num_workers
        self.rank, self.world = _world()
        self._own_server = self.rank == 0 and server is None
        if self.rank == 0 and server is None:
            server = CoordinatorServer(world_size=num_workers, ttl=ttl).start()
        self.server = server if self.rank == 0 else None
        address = _broadcast(server.address if self.rank == 0 else None, 0)
        self._uids = [f"trainer-w{i}" for i in range(num_workers)]
        owner = [int(self.devices[i * self.per_worker])
                 if self.world > 1 else 0 for i in range(num_workers)]
        self.clients: Dict[int, CoordinatorClient] = {}
        self._hb_stops: Dict[int, Any] = {}
        for i in range(num_workers):
            if owner[i] == self.rank:
                c = CoordinatorClient(address, uid=self._uids[i], ttl=ttl)
                c.connect()
                self.clients[i] = c
                self._hb_stops[i] = c.start_heartbeat_thread(
                    interval=heartbeat_interval)
        # every worker connected before anyone reads a verdict
        _broadcast(None, 0)

    def kill_worker(self, rank: int) -> None:
        """The injected death: the worker's heartbeats stop NOW (in the
        process that sends them); the verdict lands once the TTL lapses."""
        if rank in self._hb_stops:
            self._hb_stops[rank].set()

    def _dead_here(self) -> List[int]:
        by_coord = {r: self._uids.index(uid)
                    for uid, r in dict(self.server.state.ranks).items()
                    if uid in self._uids}
        return sorted(by_coord[r] for r in self.server.dead_ranks()
                      if r in by_coord)

    def dead_workers(self) -> List[int]:
        """The workers rank 0 reads dead now, on every rank."""
        return _broadcast(self._dead_here() if self.rank == 0 else None, 0)

    def wait_for_verdict(self, rank: int, timeout: float = 10.0) -> bool:
        """Block until ``rank`` is declared dead (rank 0 polls, every rank
        gets its answer)."""
        found = False
        if self.rank == 0:
            deadline = time.time() + timeout
            while time.time() < deadline:
                if rank in self._dead_here():
                    found = True
                    break
                time.sleep(0.02)
        return bool(_broadcast(found, 0))

    def surviving_devices(self, dead: Sequence[int]) -> List[Any]:
        dead = set(dead)
        out: List[Any] = []
        for r in range(self.num_workers):
            if r not in dead:
                out.extend(self.devices[r * self.per_worker:
                                        (r + 1) * self.per_worker])
        return out

    def close(self) -> None:
        for s in self._hb_stops.values():
            s.set()
        for c in self.clients.values():
            try:
                c.close()
            except Exception:
                pass
        _broadcast(None, 0)
        if self._own_server:
            self.server.stop()


@dataclass
class TrainBuild:
    """What ``build_fn(dp, ranks)`` returns: a freshly built graph on the
    layout.  ``step_fn(cursor) -> float`` runs one optimizer step on the
    batch the data cursor selects and returns the loss; ``model`` and
    ``optimizer`` feed the checkpoint plane."""
    graph: Any
    model: Any
    optimizer: Any
    step_fn: Callable[[int], float]
    close: Optional[Callable[[], None]] = None


class FaultTolerantTrainer:
    """Checkpoint -> detect -> re-plan -> verified restore -> continue,
    plus the numeric sentry's skip and rewind ladder.

    ``build_fn(dp, ranks) -> TrainBuild`` must rebuild the SAME model for
    any dp (every rank of the world calls it: the mesh's groups are made
    by all); recovery calls it on the survivors and at once overwrites
    the parameters and the optimizer's state from the snapshot, so only
    the architecture must be reproducible, not the init.

    ``rewind_after``: consecutive sentry anomalies before the ladder
    rewinds to the last good generation (single anomalies are skipped on
    the device and the step retried on fresh data).
    ``rewind_on_loss_spike``: a loss-spike verdict rewinds at once.
    ``emergency_flush``: on a death verdict, flush the current state as an
    ``emergency`` generation before re-planning (off by default).
    """

    def __init__(self, build_fn: Callable[..., TrainBuild],
                 devices: Sequence[Any],
                 monitor: Optional[WorkerMonitor] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 4,
                 solver_factory: Optional[
                     Callable[[int], StrategyModel]] = None,
                 keep_checkpoints: int = 2,
                 rewind_after: int = 3,
                 rewind_on_loss_spike: bool = True,
                 max_rewinds: int = 8,
                 emergency_flush: bool = False):
        self.build_fn = build_fn
        self.devices = list(devices)
        self.monitor = monitor
        self.checkpoint_dir = checkpoint_dir or os.path.join(
            tempfile.gettempdir(), "hetu_ft_ck")
        self.checkpoint_every = int(checkpoint_every)
        self.keep_checkpoints = int(keep_checkpoints)
        self.rewind_after = int(rewind_after)
        self.rewind_on_loss_spike = bool(rewind_on_loss_spike)
        # the ladder's bound: a deterministic pathology (every fresh batch
        # anomalous) would otherwise skip, rewind and replay for ever
        self.max_rewinds = int(max_rewinds)
        self.emergency_flush = bool(emergency_flush)
        self.solver_factory = solver_factory
        self.rank, self.world = _world()
        self.recoveries: List[Dict[str, Any]] = []
        # each committed generation: step, seconds, bytes on disk
        self.writes: List[Dict[str, Any]] = []
        self.step = 0
        self.attempts = 0
        self._handled: set = set()
        self._injected: set = set()            # fault-event identity guard
        self._ck_steps: List[int] = []
        self._killed_at: Optional[float] = None
        self._armed_kill = False
        self._rewinds_unavailable = 0
        # the data-cursor plane: committed steps PIN their cursor (a
        # rewind replays the same batches), a skip burns its cursor and
        # the retry draws a fresh one
        self._cursor_of_step: Dict[int, int] = {}
        self._next_cursor = 0
        self.burned_cursors: List[int] = []
        self.counters = {name: make_instrument("counter", name)
                         for name in TRAINER_COUNTERS}
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        self.dp = self._choose_dp(len(self.devices))
        self.build = build_fn(self.dp, self.devices)
        # the step-0 snapshot: a death before the first periodic
        # checkpoint still has something to restore
        if self._in_mesh():
            self._checkpoint()
        self._share({})

    # -- layout --------------------------------------------------------------

    def _choose_dp(self, n: int) -> int:
        if self.solver_factory is not None:
            plan = self.solver_factory(n).make_plans([1.0] * n,
                                                     top_k=1)[0]
            return int(plan.dp)
        # the largest power of two <= n: global batches are powers of two
        # and a dp that does not divide the batch cannot build (3
        # survivors of 4 recover on dp 2, one idles)
        dp = 1
        while dp * 2 <= n:
            dp *= 2
        return dp

    def _mesh(self):
        return getattr(self.build.graph, "mesh", None)

    def _in_mesh(self) -> bool:
        mesh = self._mesh()
        return mesh is None or mesh.in_mesh

    def _share(self, losses: Dict[int, float]) -> None:
        """The loop's state from the mesh's first rank to the ranks
        outside the mesh (nothing to do when the mesh spans the world)."""
        mesh = self._mesh()
        if self.world == 1 or mesh is None or mesh.size == self.world:
            return
        keys = ("step", "attempts", "_ck_steps", "_cursor_of_step",
                "_next_cursor", "burned_cursors", "recoveries", "writes",
                "_injected", "_rewinds_unavailable")
        src = mesh.ranks[0]
        state = None
        if self.rank == src:
            state = {k: getattr(self, k) for k in keys}
            state["losses"] = dict(losses)
            state["counters"] = {k: c.value
                                 for k, c in self.counters.items()}
        state = _broadcast(state, src)
        if self.rank == src:
            return
        for k in keys:
            setattr(self, k, state[k])
        losses.clear()
        losses.update(state["losses"])
        for k, v in state["counters"].items():
            c = self.counters[k]
            c.inc(v - c.value)

    # -- data-cursor plane ---------------------------------------------------

    def _cursor_for(self, step: int) -> int:
        cur = self._cursor_of_step.get(step)
        if cur is None:
            cur = self._next_cursor
            self._next_cursor += 1
            self._cursor_of_step[step] = cur
        return cur

    def _burn_cursor(self, step: int) -> None:
        cur = self._cursor_of_step.pop(step, None)
        if cur is not None:
            self.burned_cursors.append(cur)

    def committed_cursors(self) -> List[int]:
        """The cursor each committed step trained on: the clean-batch
        sequence a fault-free run must take to reproduce this run."""
        return [self._cursor_of_step[s] for s in range(self.step)
                if s in self._cursor_of_step]

    # -- checkpoint plane (checksummed generations) --------------------------

    def _checkpoint(self, emergency: bool = False) -> bool:
        from ..resilience.generations import save_generation
        from ..utils.checkpoint import WriterDeathError
        tr = get_tracer()
        t0 = time.perf_counter()
        try:
            d = save_generation(self.build.model, self.build.optimizer,
                                self.checkpoint_dir, step=self.step,
                                keep=self.keep_checkpoints,
                                emergency=emergency)
        except WriterDeathError as e:
            # the kill_mid_write verdict: the writer died between files,
            # the partial generation never committed, the earlier ones
            # stay restorable
            self.counters["checkpoint_write_failures"].inc()
            if tr.enabled:
                tr.instant("checkpoint_write_died", track="chaos",
                           ts=tr.now(), step=self.step, error=str(e))
            self._sync_ck_steps()
            return False
        self.counters["checkpoints_written"].inc()
        self.writes.append({
            "step": self.step, "emergency": bool(emergency),
            "seconds": time.perf_counter() - t0,
            "bytes": sum(os.path.getsize(os.path.join(d, f))
                         for f in os.listdir(d))})
        if tr.enabled:
            tr.instant("checkpoint", track="trainer", ts=tr.now(),
                       step=self.step, emergency=bool(emergency))
        self._sync_ck_steps(self.step)
        return True

    def _sync_ck_steps(self, new_step: Optional[int] = None) -> None:
        """This run's committed generations after retention: never a stale
        directory another process left under the same root."""
        from ..resilience.generations import MANIFEST, generation_dir
        steps = set(self._ck_steps)
        if new_step is not None:
            steps.add(int(new_step))
        self._ck_steps = [
            s for s in sorted(steps)
            if os.path.isfile(os.path.join(
                generation_dir(self.checkpoint_dir, s), MANIFEST))]

    def latest_checkpoint(self) -> int:
        return self._ck_steps[-1]

    def _restore_latest(self) -> Dict[str, Any]:
        """Verified restore: the newest generation whose digests check,
        falling back past corrupt or partial ones."""
        from ..resilience.generations import load_latest_generation
        info = load_latest_generation(self.build.model,
                                      self.build.optimizer,
                                      self.checkpoint_dir,
                                      steps=self._ck_steps)
        if info["fallbacks"]:
            self.counters["restore_fallbacks"].inc(len(info["fallbacks"]))
            tr = get_tracer()
            if tr.enabled:
                for fb in info["fallbacks"]:
                    tr.instant("restore_fallback", track="chaos",
                               ts=tr.now(), generation=fb["generation"],
                               problem=fb["problems"][0]
                               if fb["problems"] else "?")
        return info

    # -- recovery: worker death ----------------------------------------------

    def _recover(self, dead: Sequence[int], losses: Dict[int, float],
                 killed_at: Optional[float]) -> None:
        t0 = time.perf_counter()
        survivors = self.monitor.surviving_devices(self._handled)
        if not survivors:
            raise RuntimeError("every worker died; nothing to recover on")
        tr = get_tracer()
        if tr.enabled:
            tr.instant("worker_dead", track="trainer", ts=tr.now(),
                       dead=sorted(dead), survivors=len(survivors),
                       step=self.step)
        detect_step = self.step
        if self.emergency_flush and self.step not in self._ck_steps and \
                self._in_mesh():
            # a best-effort flush of the current state before the teardown
            # (digest-verified on read like every generation)
            try:
                if self._checkpoint(emergency=True):
                    self.counters["emergency_flushes"].inc()
                    if tr.enabled:
                        tr.instant("emergency_flush", track="chaos",
                                   ts=tr.now(), step=self.step)
            except Exception as e:
                self.counters["checkpoint_write_failures"].inc()
                if tr.enabled:
                    tr.instant("emergency_flush_failed", track="chaos",
                               ts=tr.now(), step=self.step,
                               error=str(e)[:120])
        # the flush's generation is every old-mesh rank's view
        self._share(losses)
        new_dp = self._choose_dp(len(survivors))
        # the dead workers' shards are gone: rebuild over the survivors
        # and restore the last durable snapshot, never the old graph's
        if self.build.close is not None:
            self.build.close()
        self.build = self.build_fn(new_dp, survivors)
        self.dp = new_dp
        if not self._in_mesh():
            return              # the ranks outside take the mesh's state
        info = self._restore_latest()
        ck_step = info["generation"]
        rewound = self.step - ck_step
        for s in range(ck_step, self.step):
            losses.pop(s, None)
        self.step = ck_step
        self.counters["worker_recoveries"].inc()
        self._reset_sentry()
        rec = {"kind": "worker_death", "dead": sorted(dead),
               "detected_at_step": detect_step,
               "resumed_from_step": ck_step, "rewound_steps": rewound,
               "restore_fallbacks": len(info["fallbacks"]),
               "dp": new_dp, "devices": len(survivors),
               "rebuild_s": time.perf_counter() - t0,
               # the MTTR anchor: the kill instant when this death was
               # injected, else the detection time
               "_t0": killed_at if killed_at is not None else t0,
               "killed_at": killed_at}
        self.recoveries.append(rec)
        if tr.enabled:
            tr.instant("recovered", track="trainer", ts=tr.now(),
                       **{k: v for k, v in rec.items()
                          if k not in ("killed_at",)})

    # -- recovery: numeric rewind --------------------------------------------

    def _reset_sentry(self) -> None:
        sentry = getattr(self.build.optimizer, "sentry", None)
        if sentry is not None:
            # the restored state predates the anomaly streak
            sentry.reset()

    def _sentry_verdict(self) -> Optional[Dict[str, Any]]:
        sentry = getattr(self.build.optimizer, "sentry", None)
        if sentry is None:
            return None
        return sentry.last_verdict()

    def _numeric_rewind(self, losses: Dict[int, float],
                        reason: str) -> None:
        t0 = time.perf_counter()
        tr = get_tracer()
        if not self._ck_steps:
            # nothing committed to rewind to: stay in skip-only mode, but
            # bounded, or a deterministic pathology loops here for ever
            self._rewinds_unavailable += 1
            if tr.enabled:
                tr.instant("sentry_rewind_unavailable", track="chaos",
                           ts=tr.now(), step=self.step, reason=reason)
            if self._rewinds_unavailable > self.max_rewinds:
                raise RuntimeError(
                    f"numeric anomaly persists with no committed "
                    f"checkpoint generation to rewind to "
                    f"({self._rewinds_unavailable} attempts, last "
                    f"reason: {reason}): skip-only mode cannot make "
                    f"progress")
            return
        if int(self.counters["rewinds"].value) >= self.max_rewinds:
            raise RuntimeError(
                f"numeric anomaly persists after {self.max_rewinds} "
                f"rewinds (last reason: {reason}): not a transient fault; "
                f"inspect the data, the lr or the model")
        if tr.enabled:
            tr.instant("sentry_rewind", track="chaos", ts=tr.now(),
                       step=self.step, reason=reason)
        info = self._restore_latest()
        ck_step = info["generation"]
        rewound = self.step - ck_step
        for s in range(ck_step, self.step + 1):
            losses.pop(s, None)
        self.step = ck_step
        self._reset_sentry()
        self.counters["rewinds"].inc()
        rec = {"kind": "numeric_rewind", "reason": reason,
               "resumed_from_step": ck_step, "rewound_steps": rewound,
               "restore_fallbacks": len(info["fallbacks"]),
               "rebuild_s": time.perf_counter() - t0,
               "_t0": t0, "mttr_pending": True}
        self.recoveries.append(rec)
        if tr.enabled:
            tr.instant("recovered", track="trainer", ts=tr.now(),
                       kind="numeric_rewind", reason=reason,
                       resumed_from_step=ck_step, rewound_steps=rewound)

    # -- chaos injection seams -----------------------------------------------

    def _apply_fault_events(self, fault_plan) -> None:
        """Every rank applies the events due at the step in one order: a
        death stops the worker's heartbeat where it beats; a numeric code
        is armed on the mesh's ranks; a shard is corrupted by the mesh's
        first rank alone (a second flip would undo the first)."""
        from ..fault.plan import NUMERIC_KINDS
        tr = get_tracer()
        numeric_armed = False
        mesh = self._mesh()
        lead = mesh is None or (mesh.in_mesh and mesh.position == 0)
        for ev in fault_plan.due(self.step):
            key = (ev.step, ev.kind, ev.target)
            if key in self._injected:
                continue
            if ev.kind == "worker_death":
                if self.monitor is None or ev.target in self._handled:
                    continue
                self._injected.add(key)
                self.monitor.kill_worker(ev.target)
                self._killed_at = time.perf_counter()
                if tr.enabled:
                    tr.instant("fault", track="chaos", ts=tr.now(),
                               kind="worker_death", target=ev.target,
                               step=self.step)
                # the verdict needs the TTL to lapse
                self.monitor.wait_for_verdict(ev.target)
            elif ev.kind in NUMERIC_KINDS:
                # one numeric poison an attempt: a second event due at the
                # same step injects on the retry
                if numeric_armed:
                    continue
                if self.monitor is not None and \
                        set(self.monitor.dead_workers()) - self._handled:
                    # a death verdict is pending: the rebuild would drop
                    # the armed code; defer (unmarked) to the retry
                    continue
                self._injected.add(key)
                numeric_armed = True
                if self._in_mesh():
                    self.build.graph.inject_numeric_fault(ev.kind)
                if tr.enabled:
                    tr.instant("fault", track="chaos", ts=tr.now(),
                               kind=ev.kind, step=self.step)
            elif ev.kind == "shard_corrupt":
                if not self._ck_steps:
                    continue   # nothing committed yet: retry when the
                    # step is revisited, never mark it injected
                self._injected.add(key)
                if lead:
                    from ..resilience.generations import \
                        corrupt_generation
                    path = corrupt_generation(self.checkpoint_dir,
                                              seed=ev.step)
                    if tr.enabled:
                        tr.instant("fault", track="chaos", ts=tr.now(),
                                   kind="shard_corrupt", step=self.step,
                                   path=os.path.basename(path))
            elif ev.kind == "kill_mid_write":
                from ..utils.checkpoint import arm_kill_mid_write
                self._injected.add(key)
                self._armed_kill = True
                arm_kill_mid_write(after_files=1)
                if tr.enabled:
                    tr.instant("fault", track="chaos", ts=tr.now(),
                               kind="kill_mid_write", step=self.step)
            # serving-plane kinds in a training plan: ignored

    # -- the loop ------------------------------------------------------------

    def train(self, total_steps: int, fault_plan=None) -> List[float]:
        """Train ``total_steps`` with death detection between steps and
        the sentry's ladder on every step's verdict.  ``fault_plan``
        events are injected at their step; a recovery rewinds to the
        newest VERIFYING snapshot and replays the same data cursors, so
        re-computed steps overwrite their losses."""
        losses: Dict[int, float] = {}
        try:
            return self._train_loop(losses, total_steps, fault_plan)
        finally:
            # an armed kill_mid_write that no write followed must not
            # outlive this trainer and kill an unrelated save
            if self._armed_kill:
                from ..utils.checkpoint import disarm_kill_mid_write
                disarm_kill_mid_write()
                self._armed_kill = False

    def _train_loop(self, losses: Dict[int, float], total_steps: int,
                    fault_plan) -> List[float]:
        tr = get_tracer()
        while self.step < total_steps:
            if fault_plan is not None:
                self._apply_fault_events(fault_plan)
            if self.monitor is not None:
                dead = set(self.monitor.dead_workers()) - self._handled
                if dead:
                    self._handled |= dead
                    self._recover(dead, losses, self._killed_at)
                    self._killed_at = None
                    if self.recoveries and self._in_mesh():
                        self.recoveries[-1]["mttr_pending"] = True
            if self._in_mesh():
                self._attempt(losses, total_steps, tr)
            self._share(losses)
        return [losses[s] for s in range(total_steps)]

    def _attempt(self, losses: Dict[int, float], total_steps: int,
                 tr) -> None:
        """One step's attempt on a rank of the mesh: the step, the
        verdict, then a skip (and maybe a rewind) or a commit (and maybe a
        checkpoint)."""
        cursor = self._cursor_for(self.step)
        loss_val = float(self.build.step_fn(cursor))
        self.attempts += 1
        verdict = self._sentry_verdict()
        if verdict is not None and verdict["anomaly"]:
            # the update was already skipped on the device; burn the
            # poisoned batch and retry the step
            self.counters["sentry_anomalies"].inc()
            self.counters["steps_skipped"].inc()
            if tr.enabled:
                tr.instant("sentry_skip", track="chaos", ts=tr.now(),
                           step=self.step, cursor=cursor,
                           **{k: verdict[k] for k in
                              ("loss_nonfinite", "grad_nonfinite",
                               "grad_spike", "loss_spike", "consecutive")})
            self._burn_cursor(self.step)
            if self.rewind_on_loss_spike and verdict["loss_spike"]:
                self._numeric_rewind(losses, reason="loss_spike")
            elif verdict["consecutive"] >= self.rewind_after:
                self._numeric_rewind(
                    losses, reason=f"{verdict['consecutive']} consecutive "
                                   f"anomalies")
            return
        losses[self.step] = loss_val
        # finalize the MTTR of EVERY recovery awaiting its first committed
        # step (a rewind can pile onto a death recovery)
        for rec in self.recoveries:
            if rec.pop("mttr_pending", False):
                t0 = rec.pop("_t0", None)
                if t0 is not None:
                    rec["mttr_s"] = time.perf_counter() - t0
        self.step += 1
        if self.step % self.checkpoint_every == 0 \
                and self.step < total_steps:
            self._checkpoint()

    # -- observability -------------------------------------------------------

    def metrics_summary(self) -> Dict[str, Any]:
        out = {name: int(c.value) for name, c in self.counters.items()}
        out["attempts"] = int(self.attempts)
        out["step"] = int(self.step)
        out["recoveries"] = len(self.recoveries)
        return out

    def metrics_text(self) -> str:
        """Prometheus exposition of the trainer's failure counters."""
        return render_prometheus(
            {f"trainer_{k}": v for k, v in self.counters.items()})

    def close(self) -> None:
        if self.build.close is not None:
            self.build.close()


def write_recovery_report(trainer: FaultTolerantTrainer,
                          path: str) -> Dict[str, Any]:
    """Freeze the recovery record (a run's artifact)."""
    out = {"recoveries": trainer.recoveries,
           "checkpoints": list(trainer._ck_steps),
           "metrics": trainer.metrics_summary(),
           "final_dp": trainer.dp}
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    return out
