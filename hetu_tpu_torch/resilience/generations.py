"""Durable checkpoint plane: checksummed generations with verified
restore (counterpart of ``hetu_tpu.resilience.generations``; no JAX in
the JAX module, so the port keeps its own copy).

* **generations** -- every save lands in its own fresh ``gen-<step>/``
  directory under the checkpoint root (no re-save mixes files from two
  saves), with retention of the last N *committed* generations.
* **manifest** -- after the tensor data is on disk, a ``manifest.json``
  is committed atomically with a blake2b digest and byte size of every
  file of the generation.  No manifest, no checkpoint: a writer killed
  mid-write (the ``kill_mid_write`` chaos verdict) leaves a directory
  that verification rejects whole.
* **verified restore** -- :func:`load_latest_generation` walks the
  generations newest first, digests every shard against the manifest
  (rejecting unmanifested stragglers too) and loads the newest that
  verifies, falling back past corrupt ones (the ``shard_corrupt``
  verdict) with a ``fallbacks`` record.

On a mesh of several ranks (the model's graph has one) every rank of the
mesh calls these functions: ``save_checkpoint`` writes each rank's file,
the mesh's first rank handles the directories, the manifest and the
pruning, and the ranks meet at barriers over the mesh
(``safetensors_io._mesh_barrier``), so every rank then sees the same
generations.  A rank outside the mesh takes no part.  The files are
written per parameter (the flat ZeRO buffers decomposed), so a
generation restores into any dp size; both packages read each other's.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

from ..utils.checkpoint.safetensors_io import (_atomic_json, _mesh_barrier,
                                               load_checkpoint,
                                               save_checkpoint)

MANIFEST = "manifest.json"
_GEN_RE = re.compile(r"^gen-(\d+)$")


def generation_dir(root: str, step: int) -> str:
    return os.path.join(root, f"gen-{int(step)}")


def list_generations(root: str) -> List[int]:
    """Steps of every generation directory under ``root`` (committed or
    not), ascending."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return []
    for name in names:
        m = _GEN_RE.match(name)
        if m and os.path.isdir(os.path.join(root, name)):
            out.append(int(m.group(1)))
    return sorted(out)


def _digest_file(path: str) -> str:
    h = hashlib.blake2b(digest_size=16)
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def write_manifest(gen_dir: str, step: int,
                   emergency: bool = False) -> Dict[str, Any]:
    """Digest every file in ``gen_dir`` and commit the manifest
    atomically: the LAST write, so a crash at any earlier point leaves a
    directory that is not a checkpoint."""
    shards: Dict[str, Dict[str, Any]] = {}
    for fn in sorted(os.listdir(gen_dir)):
        if fn == MANIFEST or fn.endswith(".tmp"):
            continue
        p = os.path.join(gen_dir, fn)
        if not os.path.isfile(p):
            continue
        shards[fn] = {"blake2b": _digest_file(p),
                      "bytes": os.path.getsize(p)}
    manifest = {"step": int(step), "emergency": bool(emergency),
                "shards": shards}
    _atomic_json(os.path.join(gen_dir, MANIFEST), manifest)
    return manifest


def verify_generation(gen_dir: str) -> Tuple[bool, List[str]]:
    """Digest a generation against its manifest.

    Rejects a missing manifest (uncommitted or partial write), a missing,
    resized or digest-mismatched shard (bit rot, truncation) and any
    unmanifested file (a stale straggler a naive loader would mix in)."""
    mpath = os.path.join(gen_dir, MANIFEST)
    if not os.path.isfile(mpath):
        return False, ["no manifest (uncommitted or partial write)"]
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return False, [f"unreadable manifest: {e}"]
    problems: List[str] = []
    shards = manifest.get("shards", {})
    for fn, ent in shards.items():
        p = os.path.join(gen_dir, fn)
        if not os.path.isfile(p):
            problems.append(f"missing shard {fn}")
            continue
        size = os.path.getsize(p)
        if size != int(ent.get("bytes", -1)):
            problems.append(f"shard {fn} is {size} B, manifest says "
                            f"{ent.get('bytes')} B")
            continue
        if _digest_file(p) != ent.get("blake2b"):
            problems.append(f"shard {fn} digest mismatch (bit rot or "
                            f"torn write)")
    for fn in sorted(os.listdir(gen_dir)):
        if fn == MANIFEST or fn.endswith(".tmp"):
            continue
        if os.path.isfile(os.path.join(gen_dir, fn)) and fn not in shards:
            problems.append(f"unmanifested file {fn} (stale shard from "
                            f"another save?)")
    return (not problems), problems


def prune_generations(root: str, keep: int) -> List[int]:
    """Remove the oldest generations beyond the newest ``keep``
    COMMITTED ones (uncommitted partials older than the oldest keeper go
    too).  Returns the steps kept."""
    steps = list_generations(root)
    committed = [s for s in steps
                 if os.path.isfile(os.path.join(generation_dir(root, s),
                                                MANIFEST))]
    keepers = set(committed[-int(keep):]) if keep > 0 else set(committed)
    floor = min(keepers) if keepers else None
    for s in steps:
        if s in keepers or (floor is not None and s >= floor):
            continue
        shutil.rmtree(generation_dir(root, s), ignore_errors=True)
    return sorted(keepers)


def _mesh_of(model):
    """The mesh of several ranks the model lives on, or None."""
    for _, p in model.named_parameters():
        mesh = getattr(p.graph, "mesh", None)
        return mesh if mesh is not None and mesh.size > 1 else None
    return None


def save_generation(model, optimizer, root: str, step: int,
                    keep: int = 2, extra: Optional[Dict[str, Any]] = None,
                    emergency: bool = False,
                    num_shards: Optional[int] = None) -> str:
    """Save one generation: a fresh ``gen-<step>/`` directory, the tensor
    data by ``save_checkpoint``, then the digest manifest, then retention
    pruning.  A writer death mid-save (the ``kill_mid_write`` hook)
    propagates BEFORE the manifest is written and before anything is
    pruned: earlier generations stay intact and verified."""
    d = generation_dir(root, step)
    mesh = _mesh_of(model)
    if mesh is not None and not mesh.in_mesh:
        return d
    lead = mesh is None or mesh.position == 0
    name = f"gen:{os.path.abspath(d)}"

    def sync(tag: str) -> None:
        if mesh is not None:
            _mesh_barrier(mesh, f"{name}:{tag}")

    aside = None
    if lead:
        if os.path.isdir(d):
            # a rewind replay or an emergency flush can re-save a step
            # that has a generation.  The save must be fresh, but a
            # committed generation is not destroyed before its
            # replacement exists: it is renamed aside (invisible to
            # list_generations) and put back if this save dies mid-write
            if os.path.isfile(os.path.join(d, MANIFEST)):
                aside = d + ".prev"
                shutil.rmtree(aside, ignore_errors=True)
                os.rename(d, aside)
            else:
                shutil.rmtree(d)
        os.makedirs(d, exist_ok=True)
    sync("open")
    try:
        save_checkpoint(model, optimizer, d, step=int(step),
                        num_shards=num_shards, extra=extra)
        if lead:
            write_manifest(d, step=int(step), emergency=emergency)
    except BaseException:
        if aside is not None:
            shutil.rmtree(d, ignore_errors=True)
            os.rename(aside, d)
        # a chaos death fires on every rank at the same file: they meet
        # here once the displaced generation is back
        sync("failed")
        raise
    if lead:
        if aside is not None:
            shutil.rmtree(aside, ignore_errors=True)
        prune_generations(root, keep)
    sync("committed")
    return d


def load_latest_generation(model, optimizer, root: str,
                           steps: Optional[List[int]] = None
                           ) -> Dict[str, Any]:
    """Restore the newest generation that VERIFIES, falling back past
    corrupt or partial ones.

    ``steps`` restricts the candidates (the trainer passes the generations
    it wrote, so a stale directory of another process is never restored).
    Returns ``{"step", "generation", "fallbacks", "dir", "extra"}``;
    ``fallbacks`` lists every newer generation that failed verification,
    with its problems.  Raises ``RuntimeError`` when nothing verifies."""
    cands = sorted(steps) if steps is not None else list_generations(root)
    fallbacks: List[Dict[str, Any]] = []
    for s in reversed(cands):
        d = generation_dir(root, s)
        if not os.path.isdir(d):
            continue
        ok, problems = verify_generation(d)
        if not ok:
            fallbacks.append({"generation": int(s), "problems": problems})
            continue
        ts = load_checkpoint(model, optimizer, d, verified=True)
        return {"step": int(ts.get("step", s)), "generation": int(s),
                "fallbacks": fallbacks, "dir": d,
                "extra": ts.get("extra", {})}
    raise RuntimeError(
        f"no checkpoint generation under {root} verifies; "
        f"rejected: {fallbacks}")


def corrupt_generation(root: str, step: Optional[int] = None,
                       nbytes: int = 16, seed: int = 0) -> str:
    """Chaos seam of the ``shard_corrupt`` verdict: flip ``nbytes``
    seeded bytes inside a tensor shard of the newest (or given) committed
    generation (the JAX package's flips).  Returns the corrupted path."""
    import numpy as np
    steps = [s for s in list_generations(root)
             if os.path.isfile(os.path.join(generation_dir(root, s),
                                            MANIFEST))]
    if not steps:
        raise RuntimeError(f"no committed generation under {root}")
    s = int(step) if step is not None else steps[-1]
    d = generation_dir(root, s)
    shard = next((fn for fn in sorted(os.listdir(d))
                  if fn.endswith(".safetensors")), None)
    if shard is None:
        raise RuntimeError(f"generation {d} has no tensor shard")
    path = os.path.join(d, shard)
    size = os.path.getsize(path)
    rng = np.random.RandomState(seed)
    with open(path, "r+b") as f:
        for _ in range(int(nbytes)):
            off = int(rng.randint(0, max(1, size)))
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([(b[0] if b else 0) ^ 0xFF]))
    return path
