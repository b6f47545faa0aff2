"""Safetensors checkpoints (counterpart of
``hetu_tpu.utils.checkpoint.safetensors_io``).

* ``save_model`` / ``load_model``: the whole model in one file, with an
  optional cast (``dtype=``) or blockwise 4-bit save (``quantize=`` fp4 /
  nf4, packed codes plus a ``<name>.absmax`` sidecar); on a mesh every
  rank gathers and rank 0 writes.
* ``save_split`` / ``load_split``: tensors split along dim 0 into
  ``num_shards`` files (one file without it) plus an ``index.json`` with
  each slice's offsets; ``save_split_async`` writes on a background
  thread after a synchronous copy to the host (``AsyncSaveHandle``).
* ``save_checkpoint`` / ``load_checkpoint``: parameters, buffers and the
  optimizer's state under the JAX package's keys (``opt.step`` int32,
  ``opt.m.<param>`` / ``opt.v.<param>`` fp32, ``opt.velocity.<param>``,
  Adafactor's ``opt.optax@@leafNNNN``), then ``trainer_state.json`` as
  the commit marker: a re-save drops the old marker first and writes the
  new one only after the tensors are on disk.  Every load is recorded in
  ``RESTORE_LOG``.  Loading copies into the tensors the graph and the
  optimizer already hold, so a captured step trains the loaded values.

The files are the JAX package's, in both directions.  The port reads and
writes the format itself (no ``safetensors`` package): an 8-byte
little-endian header length, a JSON header (``dtype``, ``shape``,
``data_offsets`` of each tensor, ``__metadata__``) padded with spaces to
a multiple of 8, then the bytes.  bf16 and fp16 tensors are stored as
``U16`` with the real dtype in the metadata (``<key>.dtype``), as the
JAX package stores them.  Values load as CPU ``torch`` tensors.

On a mesh of several ranks (the model's graph has one),
``save_checkpoint`` is the multi-process split: every rank writes its
own file, ``model_<rank>-of-<world>.safetensors``, with the slices of the
parameters it holds (each slice once: the rank at coordinate 0 of every
axis the slice is replicated over writes it, fused blocks as one slice a
block, all at their global offsets) and an ``index.<rank>.json``; rank 0
adds the optimizer's state (``checkpoint_state`` gathers it: every rank
calls it), then after a barrier over the mesh's ranks (through the
coordinator when one is registered, ``parallel.comm.barrier``; else a
collective over the mesh) merges the indices into ``index.json``, and
after another writes the marker.  With ``num_shards`` rank 0 writes the
gathered global values alone.  Loading reads global values, and each
rank keeps its shard.  A rank outside the mesh (``mesh.in_mesh`` false)
holds nothing and takes no part.

``background=True`` on a mesh is the multi-process background save: the
host copy (and rank 0's gathered optimizer state) is made before it
returns; the writer thread writes the rank's file and index and meets the
other ranks at barriers through the registered ``CoordinatorClient``
(``comm.set_coordinator``), never at a collective, which would
interleave with the training thread's.  Without a coordinator it is
refused, as in the JAX package.

The chaos seam of the JAX module: ``arm_kill_mid_write(after_files)``
makes the next write die (``WriterDeathError``) after that many files
reached the disk, before the index and the marker: a half-written
checkpoint that no manifest vouches for.
"""
from __future__ import annotations

import json
import os
import struct
import threading
from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...ops.quantization import dequantize_4bit, quantize_4bit

# safetensors dtype codes <-> numpy
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "I64": np.int64, "I32": np.int32, "I16": np.int16,
              "I8": np.int8, "U8": np.uint8, "U16": np.uint16,
              "U32": np.uint32, "U64": np.uint64, "BOOL": np.bool_}
_ST_CODES = {np.dtype(v): k for k, v in _ST_DTYPES.items()}
_VIEW_DTYPES = {torch.bfloat16: "bfloat16", torch.float16: "float16"}
_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                 "float32": torch.float32}

#: audit log of every checkpoint restore (the JAX package's record)
RESTORE_LOG = deque(maxlen=4096)


def restore_records(prefix: Optional[str] = None) -> list:
    """Copies of the restore audit records, optionally filtered to
    directories under ``prefix``."""
    if prefix is None:
        return [dict(r) for r in RESTORE_LOG]
    p = os.path.abspath(prefix)
    return [dict(r) for r in RESTORE_LOG
            if r["dir"] == p or r["dir"].startswith(p + os.sep)]


# ---------------------------------------------------------------------------
# the file format
# ---------------------------------------------------------------------------

def write_safetensors(path: str, tensors: Dict[str, np.ndarray],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Writes numpy arrays (of the safetensors dtypes) to ``path``."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    off, blobs = 0, []
    for name in sorted(tensors):
        a = np.ascontiguousarray(tensors[name])
        code = _ST_CODES.get(a.dtype)
        if code is None:
            raise TypeError(f"{name}: dtype {a.dtype} has no safetensors code")
        data = a.tobytes()
        header[name] = {"dtype": code, "shape": list(a.shape),
                        "data_offsets": [off, off + len(data)]}
        blobs.append(data)
        off += len(data)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for b in blobs:
            f.write(b)
    os.replace(tmp, path)


def read_safetensors(path: str):
    """``(tensors, metadata)`` of a safetensors file, as numpy arrays
    (16-bit floats as their bits, the dtype in ``metadata``)."""
    with open(path, "rb") as f:
        buf = f.read()
    (n,) = struct.unpack("<Q", buf[:8])
    header = json.loads(buf[8:8 + n])
    meta = header.pop("__metadata__", None) or {}
    base = 8 + n
    out = {}
    for name, ent in header.items():
        lo, hi = ent["data_offsets"]
        # BF16 (written by other tools) reads as its uint16 bits
        dt = np.dtype(_ST_DTYPES.get(ent["dtype"], np.uint16))
        a = np.frombuffer(buf, dtype=dt, count=(hi - lo) // dt.itemsize,
                          offset=base + lo).reshape(ent["shape"]).copy()
        if ent["dtype"] == "BF16":
            meta = {**meta, f"{name}.dtype": "bfloat16"}
        out[name] = a
    return out, meta


def _to_host(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))


def _host_copy(arr) -> torch.Tensor:
    """A host tensor no later in-place update reaches (a background save
    writes it while training goes on): a device tensor's copy, a host
    tensor's clone."""
    t = _to_host(arr)
    if isinstance(arr, torch.Tensor) and arr.device.type == "cpu":
        t = t.clone()
    return t


def _encode(name: str, t: torch.Tensor, meta: Dict[str, str]) -> np.ndarray:
    """A storable array for ``t``: 16-bit floats as their uint16 bits,
    the real dtype recorded in ``meta``."""
    dt = _VIEW_DTYPES.get(t.dtype)
    if dt is not None:
        meta[f"{name}.dtype"] = dt
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.contiguous().numpy()


def _decode(name: str, a: np.ndarray, meta: Dict[str, str]) -> torch.Tensor:
    dt = meta.get(f"{name}.dtype")
    t = torch.from_numpy(a)
    if dt is not None:
        return torch.from_numpy(a.view(np.int16)).view(_TORCH_DTYPES[dt])
    return t


def _dtype_name(t: torch.Tensor) -> str:
    """The JAX package's dtype string of ``t`` (numpy's names)."""
    return str(t.dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# whole-model save/load
# ---------------------------------------------------------------------------

def save_model(model, path: str, dtype: Optional[str] = None,
               quantize: Optional[str] = None, blocksize: int = 64) -> None:
    """Save ``model.state_dict()`` to a single safetensors file.

    ``dtype`` casts on save (fp32->bf16 transfer save); ``quantize`` in
    {"fp4","nf4"} writes packed-4bit + per-block absmax sidecars.
    """
    state = model.state_dict() if hasattr(model, "state_dict") else dict(model)
    if _writer_rank(model) != 0:
        return                  # rank 0 writes the gathered values
    meta: Dict[str, str] = {"format": "hetu_tpu"}
    out: Dict[str, np.ndarray] = {}
    for name, arr in state.items():
        t = _to_host(arr)
        if dtype is not None and t.is_floating_point():
            t = t.to(_TORCH_DTYPES[dtype])
        # as in the JAX package, whose numpy test of a floating dtype is
        # false for bf16: a tensor cast to (or kept in) bf16 is stored
        # whole, not quantized
        if quantize is not None and t.is_floating_point() and \
                t.dtype != torch.bfloat16 and t.ndim >= 2:
            packed, absmax = quantize_4bit(t.float(), quant_type=quantize,
                                           blocksize=blocksize)
            meta[f"{name}.quant"] = json.dumps(
                {"type": quantize, "blocksize": blocksize,
                 "shape": list(t.shape), "dtype": _dtype_name(t)})
            out[name] = packed.numpy()
            out[f"{name}.absmax"] = absmax.numpy()
            continue
        out[name] = _encode(name, t, meta)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_safetensors(path, out, meta)


def _writer_rank(model) -> int:
    """This process's rank on the model's mesh (0 without one)."""
    params = getattr(model, "parameters", None)
    p = next(iter(params()), None) if callable(params) else None
    mesh = getattr(getattr(p, "graph", None), "mesh", None)
    return mesh.rank if mesh is not None else 0


def _read_file(path: str) -> Dict[str, torch.Tensor]:
    arrays, meta = read_safetensors(path)
    state: Dict[str, torch.Tensor] = {}
    for name, a in arrays.items():
        if name.endswith(".absmax"):
            continue
        q = meta.get(f"{name}.quant")
        if q is not None:
            info = json.loads(q)
            state[name] = dequantize_4bit(
                torch.from_numpy(a), torch.from_numpy(arrays[f"{name}.absmax"]),
                tuple(info["shape"]), quant_type=info["type"],
                blocksize=info["blocksize"])
        else:
            state[name] = _decode(name, a, meta)
    return state


def read_model(path: str) -> Dict[str, torch.Tensor]:
    """The state dict in a file ``save_model`` wrote (4-bit entries
    dequantized)."""
    return _read_file(path)


def load_model(model, path: str, strict: bool = True):
    """Load a safetensors file into ``model`` (in place into its
    variables)."""
    return model.load_state_dict(_read_file(path), strict=strict)


# ---------------------------------------------------------------------------
# split save/load
# ---------------------------------------------------------------------------

class WriterDeathError(RuntimeError):
    """A simulated death of the checkpoint writer (the ``kill_mid_write``
    chaos verdict): raised between files, so the save never commits."""


# the chaos hook consulted before every shard or index write; fault
# injection arms it, normal operation leaves it None
_WRITE_CHAOS: list = [None]


def arm_kill_mid_write(after_files: int = 1) -> None:
    """Arm the ``kill_mid_write`` verdict: the NEXT write dies after
    ``after_files`` files have reached the disk, as a killed process
    leaves a checkpoint.  One-shot: it disarms when it fires."""
    box = [int(after_files)]

    def hook(fname: str) -> None:
        if box[0] <= 0:
            _WRITE_CHAOS[0] = None
            raise WriterDeathError(
                f"chaos kill_mid_write: writer died before {fname}")
        box[0] -= 1

    _WRITE_CHAOS[0] = hook


def disarm_kill_mid_write() -> None:
    _WRITE_CHAOS[0] = None


def _chaos_gate(fname: str) -> None:
    if _WRITE_CHAOS[0] is not None:
        _WRITE_CHAOS[0](fname)


def _mesh_barrier(mesh, name: str, coordinator=None) -> None:
    """A barrier over the ranks of ``mesh``: through the coordinator (the
    given one or the registered one) counting the mesh's ranks, else a
    world barrier when the mesh spans the world, else an all-reduce over
    each of its axes in turn (every rank then waited for every other)."""
    from ...parallel import comm
    coord = coordinator if coordinator is not None else comm._COORDINATOR[0]
    if coord is not None:
        comm.barrier(coordinator=coord, name=name, world_size=mesh.size,
                     timeout=1800.0)
        return
    import torch.distributed as dist
    if dist.get_world_size() == mesh.size:
        dist.barrier()
        return
    x = torch.zeros(1, device=mesh.device)
    for a in mesh.axis_names:
        if mesh.axis_size(a) > 1:
            x = comm.all_reduce(x, a, "sum", mesh)


def _file(i: int, n: int) -> str:
    return f"model_{i:05d}-of-{n:05d}.safetensors"


def _atomic_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _prune_stale_shards(dirpath: str, keep) -> None:
    """Remove shard files a previous save into this directory left."""
    for fn in os.listdir(dirpath):
        if fn.startswith("model_") and fn.endswith(".safetensors") \
                and fn not in keep:
            try:
                os.remove(os.path.join(dirpath, fn))
            except OSError:
                pass


def _host_state(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: _to_host(v) for k, v in state.items()}


def _write_split(host: Dict[str, torch.Tensor], dirpath: str,
                 num_shards: Optional[int]) -> None:
    n = num_shards or 1
    files: Dict[str, Dict[str, np.ndarray]] = {_file(i, n): {}
                                               for i in range(n)}
    metas: Dict[str, Dict[str, str]] = {f: {} for f in files}
    index: Dict[str, Any] = {"tensors": {}, "num_files": n}
    for name, t in host.items():
        ent = {"shape": list(t.shape), "dtype": _dtype_name(t), "slices": []}
        if num_shards is None or t.ndim == 0 or t.shape[0] < n:
            pieces = [(0, 0, t.shape[0] if t.ndim else None)]
        else:
            b = np.linspace(0, t.shape[0], n + 1, dtype=np.int64)
            pieces = [(i, int(b[i]), int(b[i + 1])) for i in range(n)
                      if b[i] != b[i + 1]]
        for i, lo, hi in pieces:
            fname, key = _file(i, n), f"{name}@@{i}"
            piece = t if hi is None or (lo, hi) == (0, t.shape[0]) \
                else t[lo:hi]
            files[fname][key] = _encode(key, piece, metas[fname])
            offs = [[0, d] for d in t.shape]
            if t.ndim and hi is not None:
                offs[0] = [lo, hi]
            ent["slices"].append({"file": fname, "key": key,
                                  "offsets": offs})
        index["tensors"][name] = ent
    for fname, tensors in files.items():
        _chaos_gate(fname)
        write_safetensors(os.path.join(dirpath, fname), tensors,
                          {"format": "hetu_tpu_split", **metas[fname]})
    _chaos_gate("index.json")
    _atomic_json(os.path.join(dirpath, "index.json"), index)
    _prune_stale_shards(dirpath, set(files))


def save_split(state: Dict[str, Any], dirpath: str,
               num_shards: Optional[int] = None) -> None:
    """Sharded save of a name->tensor state dict: tensors split along dim
    0 into ``num_shards`` files (one file without it), and
    ``index.json`` with each slice's offsets."""
    os.makedirs(dirpath, exist_ok=True)
    _write_split(_host_state(state), dirpath, num_shards)


class AsyncSaveHandle:
    """Handle of a background checkpoint write."""

    def __init__(self, thread, errbox):
        self._thread = thread
        self._errbox = errbox

    def done(self) -> bool:
        return not self._thread.is_alive()

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until the write finishes; re-raise any writer error."""
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("checkpoint write still in progress")
        if self._errbox:
            raise self._errbox[0]


def save_split_async(state: Dict[str, Any], dirpath: str,
                     num_shards: Optional[int] = None,
                     on_complete=None) -> AsyncSaveHandle:
    """:func:`save_split` with the file writing on a background thread.
    The copy to the host is made before it returns (the next step
    overwrites the device tensors in place); ``on_complete`` runs in the
    writer thread after a successful write."""
    os.makedirs(dirpath, exist_ok=True)
    host = {k: _host_copy(v) for k, v in state.items()}

    def _write():
        _write_split(host, dirpath, num_shards)
        if on_complete is not None:
            on_complete()

    return _start_writer(_write)


def _start_writer(write) -> AsyncSaveHandle:
    """``write()`` on a background thread; its error surfaces in
    ``wait()``."""
    errbox: list = []

    def _run():
        try:
            write()
        except BaseException as e:  # surfaced by wait()
            errbox.append(e)

    t = threading.Thread(target=_run, name="hetu-ckpt-writer", daemon=True)
    t.start()
    return AsyncSaveHandle(t, errbox)


def load_split(dirpath: str, names: Optional[list] = None
               ) -> Dict[str, torch.Tensor]:
    """Reassemble the tensors of a split checkpoint directory (whatever
    shard count wrote it)."""
    with open(os.path.join(dirpath, "index.json")) as f:
        index = json.load(f)
    files: Dict[str, Any] = {}
    out: Dict[str, torch.Tensor] = {}
    for name, ent in index["tensors"].items():
        if names is not None and name not in names:
            continue
        full = torch.zeros(tuple(ent["shape"]),
                           dtype=getattr(torch, ent["dtype"]))
        for sl in ent["slices"]:
            if sl["file"] not in files:
                files[sl["file"]] = read_safetensors(
                    os.path.join(dirpath, sl["file"]))
            arrays, meta = files[sl["file"]]
            piece = _decode(sl["key"], arrays[sl["key"]], meta)
            sel = tuple(slice(lo, hi) for lo, hi in sl["offsets"])
            full[sel] = piece.reshape(full[sel].shape)
        out[name] = full
    return out


# ---------------------------------------------------------------------------
# full checkpoint (model + optimizer + step)
# ---------------------------------------------------------------------------

def _merge_indices(dirpath: str, pcount: int) -> Dict[str, Any]:
    merged: Dict[str, Any] = {"tensors": {}, "num_files": 0}
    for i in range(pcount):
        with open(os.path.join(dirpath, f"index.{i}.json")) as f:
            part = json.load(f)
        merged["num_files"] = max(merged["num_files"], part["num_files"])
        for name, ent in part["tensors"].items():
            if name not in merged["tensors"]:
                merged["tensors"][name] = {"shape": ent["shape"],
                                           "dtype": ent["dtype"],
                                           "slices": []}
            merged["tensors"][name]["slices"].extend(ent["slices"])
    _atomic_json(os.path.join(dirpath, "index.json"), merged)
    return merged


def _rank_pieces(graph, t, value: torch.Tensor):
    """The slices of variable ``t`` this rank writes: (global slices, the
    piece) for each, or none where a rank of lower coordinate holds the
    same slice."""
    from ...parallel.mesh import dim_split, shard_pieces, spec_axes
    mesh = graph.mesh
    spec = list(t.pspec or ()) + [None] * (len(t.global_shape) -
                                           len(t.pspec or ()))
    chunk = graph._storage_axis.get(t.id)
    if chunk is not None:
        spec[0] = chunk                 # ZeRO-3: dim 0 free of other axes
    used = spec_axes(spec)
    if any(mesh.coords[a] for a in mesh.axis_names if a not in used):
        return []
    bd = t.shard_blocks_dim
    blocks = t.shard_blocks if chunk is None and spec and \
        dim_split(spec[bd], mesh)[0] > 1 else None
    return [(g, value[l]) for g, l in
            shard_pieces(t.global_shape, spec, mesh, blocks, bd)]


def _rank_snapshot(model, graph, state: Dict[str, Any], copy=False):
    """This rank's file of the multi-process split, on the host: (file
    name, encoded tensors, metadata, index); ``copy`` makes every host
    tensor a copy (a background save)."""
    host = _host_copy if copy else _to_host
    mesh = graph.mesh
    rank, world = mesh.position, mesh.size
    fname = _file(rank, world)
    tensors: Dict[str, np.ndarray] = {}
    meta: Dict[str, str] = {}
    index: Dict[str, Any] = {"tensors": {}, "num_files": world}
    for fn in graph._materializers:
        fn(graph)
    for name, p in model.named_parameters():
        val = host(graph.get_tensor_value(p))
        ent = {"shape": list(p.global_shape or p.shape),
               "dtype": _dtype_name(val), "slices": []}
        for k, (gsl, piece) in enumerate(_rank_pieces(graph, p, val)):
            key = f"{name}@@{k}"
            tensors[key] = _encode(key, piece.contiguous(), meta)
            ent["slices"].append({"file": fname, "key": key, "offsets": [
                [s_.start, s_.stop] for s_ in gsl]})
        if ent["slices"]:
            index["tensors"][name] = ent
    if rank == 0:
        for name, v in state.items():
            t = host(v)
            key = f"{name}@@0"
            tensors[key] = _encode(key, t, meta)
            index["tensors"][name] = {
                "shape": list(t.shape), "dtype": _dtype_name(t),
                "slices": [{"file": fname, "key": key,
                            "offsets": [[0, d] for d in t.shape]}]}
    return fname, tensors, meta, index


def _write_ranks(snap, dirpath: str, mesh, barrier) -> None:
    """The multi-process split from a snapshot: this rank's file and
    index, ``barrier()``, rank 0's merge, ``barrier()``."""
    fname, tensors, meta, index = snap
    rank, world = mesh.position, mesh.size
    _chaos_gate(fname)
    write_safetensors(os.path.join(dirpath, fname), tensors,
                      {"format": "hetu_tpu_split", **meta})
    _chaos_gate(f"index.{rank}.json")
    _atomic_json(os.path.join(dirpath, f"index.{rank}.json"), index)
    barrier("")
    if rank == 0:
        for fn in os.listdir(dirpath):
            parts = fn.split(".")
            if fn.startswith("index.") and len(parts) == 3 and \
                    parts[1].isdigit() and int(parts[1]) >= world:
                os.remove(os.path.join(dirpath, fn))
        merged = _merge_indices(dirpath, world)
        _prune_stale_shards(dirpath, {sl["file"] for ent in
                                      merged["tensors"].values()
                                      for sl in ent["slices"]})
    barrier(":merged")


def save_checkpoint(model, optimizer, dirpath: str, step: int = 0,
                    num_shards: Optional[int] = None,
                    extra: Optional[Dict[str, Any]] = None,
                    background: bool = False
                    ) -> Optional[AsyncSaveHandle]:
    """Save parameters, buffers, the optimizer's state and ``step`` to
    ``dirpath``; with ``background`` the files are written on a thread
    (call ``.wait()`` on the returned handle)."""
    params = dict(model.named_parameters())
    graph = next(iter(params.values())).graph if params else None
    mesh = getattr(graph, "mesh", None)
    ranks = mesh is not None and mesh.size > 1
    if mesh is not None and not mesh.in_mesh:
        return None                  # the rank holds nothing of the mesh
    coord = None
    if ranks and background:
        from ...parallel import comm
        coord = comm._COORDINATOR[0]
        if coord is None:
            raise RuntimeError(
                "background save with multiple processes needs a "
                "registered CoordinatorClient (comm.set_coordinator): the "
                "collective barrier cannot run on the writer thread")
    os.makedirs(dirpath, exist_ok=True)
    state: Dict[str, Any] = {}
    if not ranks or num_shards is not None:
        for name, p in params.items():
            state[name] = graph.global_value(p) if ranks \
                else p.graph.get_tensor_value(p)
    for name, b in model.named_buffers():
        state[name] = b
    if optimizer is not None:
        tid_to_name = {p.id: n for n, p in params.items()}
        for key, val in optimizer.checkpoint_state(tid_to_name).items():
            state[f"opt.{key}"] = val
    marker = os.path.join(dirpath, "trainer_state.json")
    lead = not ranks or mesh.position == 0
    if os.path.exists(marker) and lead:
        # a re-save drops the old marker first: a crash mid-write must not
        # leave a marker that vouches for mixed-step tensor files
        os.remove(marker)

    def _write_marker():
        # the commit marker, only after the tensors are on disk
        _atomic_json(marker, {"step": int(step), "extra": extra or {}})

    if ranks:
        name = f"ckpt:{os.path.abspath(dirpath)}"

        def barrier(suffix):
            _mesh_barrier(mesh, name + suffix, coordinator=coord)

        if background:
            # the host snapshot now (the next step overwrites the device
            # tensors in place), the files and barriers on the writer
            snap = _rank_snapshot(model, graph, state, copy=True) \
                if num_shards is None else None
            host = {k: _host_copy(v) for k, v in state.items()} \
                if lead and num_shards is not None else None

            def _write():
                if snap is not None:
                    _write_ranks(snap, dirpath, mesh, barrier)
                elif lead:
                    _write_split(host, dirpath, num_shards)
                if lead:
                    _write_marker()

            return _start_writer(_write)
        if num_shards is None:
            _write_ranks(_rank_snapshot(model, graph, state), dirpath, mesh,
                         barrier)
        else:
            if lead:
                save_split(state, dirpath, num_shards=num_shards)
            barrier("")
        if lead:
            _write_marker()
        barrier(":marker")
        return None

    if background:
        return save_split_async(state, dirpath, num_shards=num_shards,
                                on_complete=_write_marker)
    save_split(state, dirpath, num_shards=num_shards)
    _write_marker()
    return None


def load_checkpoint(model, optimizer, dirpath: str,
                    verified: bool = False,
                    verify_exempt: bool = False) -> Dict[str, Any]:
    """Load a checkpoint saved by :func:`save_checkpoint` (by either
    package) into ``model`` and ``optimizer``; returns the trainer state
    (``{"step", "extra"}``).  ``verified`` / ``verify_exempt`` are
    recorded in :data:`RESTORE_LOG` as in the JAX package."""
    params = dict(model.named_parameters())
    mesh = getattr(next(iter(params.values())).graph, "mesh", None) \
        if params else None
    if mesh is not None and not mesh.in_mesh:
        # the rank holds nothing of the mesh: nothing to load
        with open(os.path.join(dirpath, "trainer_state.json")) as f:
            return json.load(f)
    state = load_split(dirpath)
    model.load_state_dict({k: v for k, v in state.items()
                           if not k.startswith("opt.")}, strict=False)
    if optimizer is not None:
        params = dict(model.named_parameters())
        device = next(iter(params.values())).graph.device
        optimizer.load_checkpoint_state(
            {k[len("opt."):]: v for k, v in state.items()
             if k.startswith("opt.")}, params, device)
    ts_path = os.path.join(dirpath, "trainer_state.json")
    ts = {"step": 0, "extra": {}}
    if os.path.exists(ts_path):
        with open(ts_path) as f:
            ts = json.load(f)
    RESTORE_LOG.append({"dir": os.path.abspath(dirpath),
                        "verified": bool(verified),
                        "verify_exempt": bool(verify_exempt),
                        "step": int(ts.get("step", 0))})
    return ts
