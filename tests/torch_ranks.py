"""Rank processes of a gloo group on the CPU, for the port's multi-process
tests (tests/test_torch_comm.py, tests/test_torch_parallel.py,
tests/test_torch_rpc_launch.py, tests/test_torch_ring_attention.py,
tests/test_torch_ulysses.py, tests/test_torch_cp_model.py,
tests/test_torch_resilience.py, tests/test_torch_ft.py).

``run_ranks(case, world, args, tmp)`` starts ``world`` fresh interpreters
running this file (``python tests/torch_ranks.py RANK WORLD INIT CASE
ARGS OUT``), each joining a gloo group through a ``file://`` rendezvous
under ``tmp`` with a 60 s collective timeout and one intra-op thread,
runs ``CASES[case](rank, world, **args)`` and pickles its result.  The
parent waits up to ``timeout`` seconds, kills every rank on a timeout or
a failure, and raises with the ranks' error output.  The ranks import
the port and never JAX.
"""
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(case, world, args, tmp, timeout=150.0):
    """``CASES[case]`` on ``world`` gloo ranks; their results in rank
    order."""
    tmp = str(tmp)
    init = os.path.join(tmp, f"init_{case}_{world}_{time.time_ns()}")
    arg_path = os.path.join(tmp, f"args_{case}_{world}.pkl")
    with open(arg_path, "wb") as f:
        pickle.dump(args, f)
    outs = [os.path.join(tmp, f"out_{case}_{world}_{r}.pkl")
            for r in range(world)]
    logs = [open(os.path.join(tmp, f"log_{case}_{world}_{r}.txt"), "w+")
            for r in range(world)]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world), init,
         case, arg_path, outs[r]], cwd=REPO, env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.time() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].poll()}"
                break
            if time.time() > deadline:
                failed = f"timed out after {timeout} s"
                break
            time.sleep(0.05)
        if failed is None and any(p.returncode != 0 for p in procs):
            failed = f"exit codes {[p.returncode for p in procs]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    if failed is not None:
        text = []
        for r, f in enumerate(logs):
            f.seek(0)
            text.append(f"--- rank {r}\n{f.read()[-3000:]}")
        raise AssertionError(f"{case} on {world} ranks: {failed}\n" +
                             "\n".join(text))
    for f in logs:
        f.close()
    results = []
    for o in outs:
        with open(o, "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# the cases (run inside the ranks)
# ---------------------------------------------------------------------------

def case_collectives(rank, world, mesh_shape, inputs):
    """Each plain and coalesced collective over axis ``x`` of a mesh of
    ``mesh_shape``, on this rank's input, and the autograd pairs'
    forward values and input gradients."""
    import torch
    from hetu_tpu_torch.parallel import comm, create_mesh
    mesh = create_mesh(mesh_shape, device="cpu")
    n = mesh.axis_size("x")
    x = torch.from_numpy(inputs[rank])
    out = {}
    with mesh, comm.comm_stats() as st:
        out["all_reduce"] = comm.all_reduce(x, "x").numpy()
        out["all_reduce_max"] = comm.all_reduce(x, "x", "max").numpy()
        out["all_reduce_mean"] = comm.all_reduce(x, "x", "mean").numpy()
        out["all_gather0"] = comm.all_gather(x, "x", 0).numpy()
        out["all_gather1"] = comm.all_gather(x, "x", 1).numpy()
        out["reduce_scatter"] = comm.reduce_scatter(x, "x", 0).numpy()
        out["all_to_all"] = comm.all_to_all(x, "x", 0, 1).numpy()
        out["broadcast"] = comm.broadcast(x, "x", root=1).numpy()
        out["reduce"] = comm.reduce(x, "x", root=0).numpy()
        out["ring_shift"] = comm.ring_shift(x, "x", 1).numpy()
        out["partial_reduce"] = comm.partial_reduce(
            x, "x", comm.axis_index("x") % 2 == 0).numpy()
        uneven = [[0], list(range(1, n))]
        out["split_all_reduce"] = comm.split_all_reduce(
            x, "x", uneven).numpy()
        out["split_all_gather"] = comm.split_all_gather(
            x, "x", 0, uneven).numpy()
        out["split_reduce_scatter"] = comm.split_reduce_scatter(
            x, "x", 0, uneven).numpy()
        grads = {"a": x[:3].clone(), "b": x[3:].reshape(-1).clone()}
        for tr in ("fp32", "bf16", "int8"):
            red = comm.all_reduce_coalesced(grads, "x", op="mean",
                                            transport=tr, block=4)
            out[f"coalesced_{tr}"] = {k: v.numpy() for k, v in red.items()}
            chunks, lay = comm.reduce_scatter_coalesced(
                grads, "x", op="sum", transport=tr, block=4)
            full = comm.all_gather_coalesced(chunks, lay, "x", transport=tr,
                                             block=4)
            out[f"rs_ag_{tr}"] = {k: v.numpy() for k, v in full.items()}
        v = x.clone().requires_grad_(True)
        pairs = {
            "copy_to_group": lambda t: comm.copy_to_group(t, "x"),
            "reduce_from_group": lambda t: comm.reduce_from_group(t, "x"),
            "gather_from_group": lambda t: comm.gather_from_group(t, "x", 0),
            "reduce_scatter_to_group":
                lambda t: comm.reduce_scatter_to_group(t, "x", 0),
            "split_to_group": lambda t: comm.split_to_group(t, "x", 0),
            "gather_output": lambda t: comm.gather_output(t, "x", 1)}
        for name, fn in pairs.items():
            y = fn(v)
            w = torch.arange(y.numel(), dtype=torch.float32).reshape(
                y.shape) / 7.0
            (g,) = torch.autograd.grad((y * w).sum(), v)
            out[f"pair_{name}"] = (y.detach().numpy(), g.numpy())
    out["records"] = [tuple(r) for r in st.records]
    return out


def case_many(rank, world, jobs):
    """Several cases in one launch: ``jobs`` is a list of (case name,
    kwargs); their results in order."""
    return [CASES[c](rank, world, **kw) for c, kw in jobs]


def _dist_state(state_path):
    data = np.load(state_path)
    return {k: data[k] for k in data.files}


def case_train(rank, world, state_path, batch_path, cfg_kw, layouts,
               steps=3, lr=1e-3, micro=2):
    """Each layout trains ``steps`` Adam steps of the tiny model from the
    given (JAX) state on the global batch: (losses, gathered weights)."""
    import torch
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.models.convert import load_state
    from hetu_tpu_torch.models.generate import _Params
    from hetu_tpu_torch.parallel import P, comm, create_mesh
    state = _dist_state(state_path)
    b = np.load(batch_path)
    x, y = b["x"], b["y"]
    out = {}
    for name, shape, sp, opt_kw in layouts:
        mesh = create_mesh(shape, device="cpu")
        with ht.graph("define_and_run", create_new=True, mesh=mesh,
                      seed=0) as g:
            ids = ht.parallel_placeholder("int32", x.shape,
                                          pspec=P("dp", None), name="ids")
            labels = ht.parallel_placeholder("int32", y.shape,
                                             pspec=P("dp", None),
                                             name="labels")
            model = GPTLMHeadModel(GPTConfig(**cfg_kw, sp=sp))
            loss = model(ids, labels)
            train_op = optim.AdamOptimizer(lr=lr, **opt_kw).minimize(loss)
        load_state(model, state)
        losses = []
        with comm.comm_stats() as st:
            for _ in range(steps):
                l, _ = g.run(loss, [loss, train_op], {ids: x, labels: y},
                             num_micro_batches=micro)
                losses.append(float(l))
        weights = {_Params._norm(n): g.global_value(p).numpy()
                   for n, p in model.named_parameters()}
        out[name] = {"losses": losses,
                     "weights": weights if rank == 0 else None,
                     "records": [tuple(r) for r in st.records],
                     "captured": g.last_run_captured}
    return out


def case_train_many(rank, world, jobs):
    """``case_train`` for each named job."""
    return {name: case_train(rank, world, **kw) for name, kw in jobs.items()}


GRAD_COMM_ROUTES = {
    # name: (optimizer keywords, extra fetch, loss reduced by reduce_sum)
    "loss": ({"grad_comm": "fp32"}, None, False),
    "loss_and_ids": ({"grad_comm": "fp32"}, "ids", False),
    "extra_scalar": ({"grad_comm": "fp32"}, "scalar", False),
    "unsharded_fetch": ({"grad_comm": "fp32"}, "unsharded", False),
    "sum_loss": ({"grad_comm": "fp32"}, None, True),
    "no_grad_comm": ({}, None, False),
    "zero3": ({"grad_comm": "fp32", "zero": 3}, None, False),
}


def grad_comm_graph(pkg, P, cfg_kw, shape, name, **graph_kw):
    """A tiny MoE GPT on a dp mesh of ``pkg`` (the port or the JAX
    package) built for the ``GRAD_COMM_ROUTES`` entry ``name``: (graph,
    optimizer, loss, fetches, feeds as a function of (x, y))."""
    opt_kw, extra, summed = GRAD_COMM_ROUTES[name]
    ht, optim, GPTConfig, GPTLMHeadModel, F = pkg
    with ht.graph("define_and_run", create_new=True, **graph_kw) as g:
        ids = ht.parallel_placeholder("int32", shape, pspec=P("dp", None),
                                      name="ids")
        labels = ht.parallel_placeholder("int32", shape,
                                         pspec=P("dp", None), name="labels")
        model = GPTLMHeadModel(GPTConfig(**cfg_kw, sp=False))
        loss = model(ids, labels)
        if summed:
            loss = F.reduce_sum(loss)
        opt = optim.AdamOptimizer(lr=1e-2, **opt_kw)
        op = opt.minimize(loss)
        fetches, extra_feed = [loss], {}
        if extra == "ids":
            fetches.append(ids)
        elif extra == "scalar":
            fetches.append(loss * 1.0)
        elif extra == "unsharded":
            free = ht.placeholder("float32", (4,), name="free")
            fetches.append(free)
            extra_feed[free] = np.zeros(4, np.float32)
    return g, model, opt, loss, fetches, op, \
        lambda x, y: {ids: x, labels: y, **extra_feed}


def case_grad_comm_routing(rank, world, state_path, batch_path, cfg_kw,
                           micro=2):
    """For each ``GRAD_COMM_ROUTES`` entry on a ``{"dp": world}`` mesh,
    whether the optimizer's step routes each rank's tokens alone
    (``Optimizer.dp_local_tokens``), and one step's loss for the entries
    that fetch the loss alone or with another scalar."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.models.convert import load_state
    from hetu_tpu_torch.ops import functional
    from hetu_tpu_torch.parallel import P, create_mesh
    state = _dist_state(state_path)
    b = np.load(batch_path)
    x, y = b["x"], b["y"]
    out = {}
    for name in GRAD_COMM_ROUTES:
        mesh = create_mesh({"dp": world}, device="cpu")
        g, model, opt, loss, fetches, op, feeds = grad_comm_graph(
            (ht, optim, GPTConfig, GPTLMHeadModel, functional), P, cfg_kw,
            x.shape, name, mesh=mesh, seed=0)
        local = opt.dp_local_tokens(g, fetches, loss)
        first = None
        if name in ("loss", "extra_scalar"):
            load_state(model, state)
            first = float(g.run(loss, fetches + [op], feeds(x, y),
                                num_micro_batches=micro)[0])
        out[name] = {"local": local, "first_loss": first}
    return out


def case_stats(rank, world, mesh_shape, entries, layouts, bucket_mb=4.0):
    """One update of an optimizer per layout over the ``dp`` axis of a
    mesh of ``mesh_shape``, with the collectives recorded: the gradients
    are random tensors of ``entries`` (name, shape, dtype)."""
    import torch
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.parallel import P, comm, create_mesh
    out = {}
    for name, opt_kw in layouts:
        mesh = create_mesh(mesh_shape, device="cpu")
        with ht.graph("define_and_run", create_new=True, mesh=mesh,
                      seed=0) as g:
            xs = [ht.parallel_parameter(
                ht.NormalInitializer(0.0, 0.02), shape, dtype=dt, name=n)
                for n, shape, dt in entries]
            opt = optim.AdamOptimizer(lr=1e-3, bucket_mb=bucket_mb,
                                      **opt_kw)
            opt._graph = g
        for t in xs:
            g._materialize_var(t)
        rng = np.random.RandomState(rank)
        grads = [torch.from_numpy(rng.standard_normal(
            t.concrete_shape()).astype(np.float32)).to(t.dtype) for t in xs]
        with comm.comm_stats() as st:
            opt._before_step(g, xs)
            opt._apply_updates(g, xs, grads)
        out[name] = [tuple(r) for r in st.records]
    return out


def case_ce(rank, world, mesh_shape, logits, labels):
    """``vocab_parallel_cross_entropy`` of this rank's shard of the
    global logits (rows over dp, vocab over tp) for each dtype: the
    loss, its dtype and the shard's gradient."""
    import torch
    from hetu_tpu_torch import nn
    from hetu_tpu_torch.parallel import create_mesh
    mesh = create_mesh(mesh_shape, device="cpu")
    dp, tp = mesh.axis_size("dp"), mesh.axis_size("tp")
    i, j = mesh.axis_index("dp"), mesh.axis_index("tp")
    rows, vocab = logits.shape[0] // dp, logits.shape[-1] // tp
    out = {}
    for dt in ("float32", "bfloat16"):
        lg = torch.from_numpy(
            logits[i * rows:(i + 1) * rows, :, j * vocab:(j + 1) * vocab]
        ).to(getattr(torch, dt)).requires_grad_(True)
        t = torch.from_numpy(labels[i * rows:(i + 1) * rows])
        with mesh:
            loss = nn.vocab_parallel_cross_entropy(lg, t, ignore_index=-100)
        (g,) = torch.autograd.grad(loss, lg)
        out[dt] = (float(loss), str(loss.dtype), g.float().numpy())
    return out


def case_checkpoint(rank, world, cfg_kw, mesh_shape, save_dir,
                    state_path=None, load_dir=None, opt_kw=None):
    """The tiny model from ``state_path`` or a checkpoint (``load_dir``),
    one Adam step on a fixed batch, a split checkpoint saved from every
    rank: the step's loss and the gathered weights after it."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.models.convert import load_state
    from hetu_tpu_torch.models.generate import _Params
    from hetu_tpu_torch.parallel import P, create_mesh
    from hetu_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    mesh = create_mesh(mesh_shape, device="cpu")
    x, y = checkpoint_batch(cfg_kw["vocab_size"])
    with ht.graph("define_and_run", create_new=True, mesh=mesh, seed=0) as g:
        ids = ht.parallel_placeholder("int32", x.shape, pspec=P("dp", None))
        labels = ht.parallel_placeholder("int32", y.shape,
                                         pspec=P("dp", None))
        model = GPTLMHeadModel(GPTConfig(**cfg_kw))
        loss = model(ids, labels)
        opt = optim.AdamOptimizer(lr=1e-3, **(opt_kw or {}))
        train_op = opt.minimize(loss)
    if load_dir is not None:
        load_checkpoint(model, opt, load_dir, verify_exempt=True)
    else:
        load_state(model, _dist_state(state_path))
    l, _ = g.run(loss, [loss, train_op], {ids: x, labels: y})
    save_checkpoint(model, opt, save_dir, step=1)
    return {"loss": float(l),
            "weights": {_Params._norm(n): g.global_value(p).numpy()
                        for n, p in model.named_parameters()}}


def checkpoint_batch(vocab):
    x = (np.arange(4 * 8, dtype=np.int32).reshape(4, 8) * 7) % vocab
    return x, x[:, ::-1].copy()


def case_permute(rank, world, perms):
    """``comm.permute_group`` over axis ``x``: for each permutation the
    forward value, ``gradcheck`` of the op (float64; every rank runs the
    same perturbations, so the exchanges pair up), the gradient of a
    weighted sum and the records."""
    import torch
    from hetu_tpu_torch.parallel import comm, create_mesh
    mesh = create_mesh({"x": world}, device="cpu")
    out = []
    for perm in perms:
        x = (torch.arange(6, dtype=torch.float64).reshape(3, 2) + 10 * rank
             ).requires_grad_(True)
        with comm.comm_stats() as st, comm.comm_tag("hop"):
            y = comm.permute_group(x, "x", perm, mesh)
            w = torch.full_like(y, float(rank + 1))
            (g,) = torch.autograd.grad((y * w).sum(), x)
        ok = torch.autograd.gradcheck(
            lambda t: comm.permute_group(t, "x", perm, mesh), (x,))
        out.append({"y": y.detach().numpy(), "grad": g.numpy(),
                    "gradcheck": bool(ok),
                    "records": [tuple(r) for r in st.records]})
    return out


def case_aux(rank, world, x, ws, micro):
    """``pipeline_spmd`` with ``with_aux`` over the ``pp`` axis of ``{"r":
    2, "pp": 2}``: stage ``s`` scales by ``ws[s]`` and reports its
    output's sum; the output, the aux and the gradients of ``out.sum() +
    aux`` for the input and the rank's stage weight."""
    import torch
    from hetu_tpu_torch.parallel import create_mesh
    from hetu_tpu_torch.parallel.pipeline import pipeline_spmd
    mesh = create_mesh({"r": 2, "pp": 2}, device="cpu")
    s = mesh.axis_index("pp")
    w = torch.tensor([[ws[s]]], dtype=torch.float64, requires_grad=True)
    xx = torch.from_numpy(x).requires_grad_(True)

    def stage_fn(p, v):
        y = v * p["w"][0]
        return y, y.sum()

    out, aux = pipeline_spmd(stage_fn, {"w": w}, xx, micro, mesh,
                             with_aux=True)
    gx, gw = torch.autograd.grad(out.sum() + aux, [xx, w])
    return {"out": out.detach().numpy(), "aux": float(aux.detach()),
            "gx": gx.numpy(), "gw": float(gw[0, 0]), "stage": s}


def case_pipeline(rank, world, state_path, batch_path, mk, layouts,
                  steps=3, lr=1e-2):
    """``GPTPipelineModel`` from a JAX pipeline model's state (pp 1,
    stacked ``[1, L, ...]``) on each layout ``(name, mesh shape, config
    overrides, micro-batches, optimizer options)``: the Adam losses, the
    ``wte`` gradient of the first batch at the initial weights (local:
    whole under dp 1), the gathered weights against the loaded ones, the
    collectives of the first step, the gathered weights after the run
    (rank 0) and, under ZeRO, the parameters it splits over dp."""
    import torch
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.models import gpt as tgpt
    from hetu_tpu_torch.models.convert import pipeline_state, plain_state
    from hetu_tpu_torch.models.gpt_pipeline import GPTPipelineModel
    from hetu_tpu_torch.parallel import P, comm, create_mesh
    base = _dist_state(state_path)
    b = np.load(batch_path)
    x, y = b["x"], b["y"]
    out = {}
    for name, shape, cfg_kw, micro, opt_kw in layouts:
        mesh = create_mesh(shape, device="cpu")
        cfg = getattr(tgpt, mk["fn"])(**{**mk["kw"], **cfg_kw})
        S = mesh.axis_size("pp")
        with ht.graph("define_and_run", create_new=True, mesh=mesh,
                      seed=0) as g:
            ids = ht.parallel_placeholder("int32", x.shape,
                                          pspec=P("dp", None), name="ids")
            labels = ht.parallel_placeholder("int32", y.shape,
                                             pspec=P("dp", None),
                                             name="labels")
            model = GPTPipelineModel(cfg, num_stages=S)
            loss = model(ids, labels, num_micro_batches=micro)
            (g_wte,) = ht.gradients(loss, [model.wte.weight])
            train_op = optim.AdamOptimizer(lr=lr, **opt_kw).minimize(loss)
        loaded = pipeline_state(plain_state(base, cfg), cfg, S)
        model.load_state_dict(loaded)
        # the gathered weights (every stage and tp block back in place)
        init_diff = max(float(np.abs(v.numpy() - loaded[k]).max())
                        for k, v in model.state_dict().items())
        (wte_grad,) = g.run([g_wte], feed_dict={ids: x, labels: y})
        losses, records = [], None
        for i in range(steps):
            with comm.comm_stats() as st:
                l, _ = g.run(loss, [loss, train_op], {ids: x, labels: y})
            losses.append(float(l))
            if i == 0:
                records = [tuple(r) for r in st.records]
        state = {k: v.numpy() for k, v in model.state_dict().items()}
        out[name] = {"losses": losses, "wte_grad": wte_grad.numpy(),
                     "init_diff": init_diff,
                     "records": records,
                     "state": state if rank == 0 else None,
                     "zero_chunked": sorted(
                         n for n, p in model.named_parameters()
                         if train_op.producer.attrs["optimizer"]._chunked(
                             g, p)) if opt_kw.get("zero") else None}
    return out


def case_pipeline_feed_refusal(rank, world, mk, shape, mesh_shape):
    """A MoE ``GPTPipelineModel`` on a mesh with dp whose ids come from
    another op than a placeholder: the refusal's words (None: built)."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.models import gpt as tgpt
    from hetu_tpu_torch.models.gpt_pipeline import GPTPipelineModel
    from hetu_tpu_torch.ops import functional as F
    from hetu_tpu_torch.parallel import P, create_mesh
    mesh = create_mesh(mesh_shape, device="cpu")
    cfg = getattr(tgpt, mk["fn"])(**mk["kw"])
    with ht.graph("define_and_run", create_new=True, mesh=mesh, seed=0):
        ids = ht.parallel_placeholder("int32", shape, pspec=P("dp", None),
                                      name="ids")
        model = GPTPipelineModel(cfg, num_stages=mesh.axis_size("pp"))
        try:
            model(F.reshape(ids, ids.shape), ids, num_micro_batches=2)
        except NotImplementedError as e:
            return str(e)
    return None


def _block(mesh, axis, n_global):
    """This rank's contiguous block of ``n_global`` over ``axis``."""
    n = mesh.axis_size(axis)
    i = mesh.axis_index(axis)
    w = n_global // n
    return slice(i * w, (i + 1) * w)


def case_cp_attention(rank, world, jobs):
    """Ring and Ulysses attention on this rank's shard of global ``[b, s,
    h, d]`` inputs (the sequence over ``cp``, the batch over ``dp`` and
    the heads over ``tp`` where the mesh has them): for each job the
    rank's slices, its output and, with a cotangent ``do``, the
    gradients of ``sum(out * do)``; a job that raises returns the
    error's type and message."""
    import torch
    from hetu_tpu_torch.parallel import comm, create_mesh
    from hetu_tpu_torch.parallel.ring_attention import ring_attention_sharded
    from hetu_tpu_torch.parallel.ulysses import (ulysses_attention,
                                                 ulysses_attention_sharded)
    out = []
    meshes = {}
    for job in jobs:
        key = tuple(sorted(job["mesh"].items()))
        if key not in meshes:
            meshes[key] = create_mesh(job["mesh"], device="cpu")
        mesh = meshes[key]
        b, s, h = job["q"].shape[:3]
        hk = job["k"].shape[2]
        bs = _block(mesh, "dp", b)
        ss = _block(mesh, "cp", s)
        hs, hks = _block(mesh, "tp", h), _block(mesh, "tp", hk)
        dt = getattr(torch, job.get("dtype", "float32"))

        def local(x, heads):
            return torch.from_numpy(np.ascontiguousarray(
                x[bs, ss, heads])).to(dt).requires_grad_(True)
        q, k, v = local(job["q"], hs), local(job["k"], hks), \
            local(job["v"], hks)
        segs = job.get("segment_ids")
        if segs is not None:
            segs = torch.from_numpy(np.ascontiguousarray(segs[bs, ss]))
        kw = dict(causal=job.get("causal", True), segment_ids=segs)
        res = {"name": job["name"], "b": (bs.start, bs.stop),
               "s": (ss.start, ss.stop), "h": (hs.start, hs.stop)}
        try:
            with comm.comm_stats() as st:
                if job.get("impl", "ring") == "ring":
                    o = ring_attention_sharded(
                        q, k, v, mesh, split_pattern=job.get("pattern",
                                                             "normal"),
                        seq_lens=job.get("seq_lens"), **kw)
                elif job["impl"] == "ulysses":
                    o = ulysses_attention_sharded(q, k, v, mesh, **kw)
                else:                       # the unpadded local op
                    o = ulysses_attention(q, k, v, mesh=mesh, **kw)
                res["out"] = o.detach().float().numpy()
                res["dtype"] = str(o.dtype)
                if job.get("do") is not None:
                    do = torch.from_numpy(np.ascontiguousarray(
                        job["do"][bs, ss, hs])).to(o.dtype)
                    grads = torch.autograd.grad((o * do).sum(), [q, k, v])
                    res["grads"] = [x.float().numpy() for x in grads]
            res["records"] = [tuple(r) for r in st.records]
        except Exception as e:          # the refusals the tests expect
            res["error"] = (type(e).__name__, str(e))
        out.append(res)
    return out


def case_ring_profile(rank, world, q, k, v, path):
    """``profile_ring_breakdown`` on this rank's block (sym, causal) with
    a ``Metrics`` recorder, then the ``HETU_TPU_RING_PROFILE`` hook inside
    ``ring_attention_sharded``, called twice at one shape and once at
    another: the rows, the recorder's series lengths, the profiled keys
    and the lines of this rank's JSONL file."""
    import importlib
    import torch
    from hetu_tpu_torch.parallel import create_mesh
    from hetu_tpu_torch.utils.metrics import Metrics
    ra = importlib.import_module("hetu_tpu_torch.parallel.ring_attention")
    mesh = create_mesh({"cp": world}, device="cpu")
    ss = _block(mesh, "cp", q.shape[1])
    q, k, v = (torch.from_numpy(np.ascontiguousarray(x[:, ss]))
               for x in (q, k, v))
    rec = Metrics()
    rows = ra.profile_ring_breakdown(q, k, v, mesh, split_pattern="sym",
                                     reps=1, metrics=rec)
    os.environ["HETU_TPU_RING_PROFILE"] = "1"
    os.environ["HETU_TPU_RING_PROFILE_BWD"] = "0"
    os.environ["HETU_TPU_RING_PROFILE_FILE"] = path
    ra._RING_PROFILED.clear()
    ra.ring_attention_sharded(q, k, v, mesh)
    ra.ring_attention_sharded(q, k, v, mesh)
    keys_after_two = len(ra._RING_PROFILED)
    half = slice(0, q.shape[1] // 2)
    ra.ring_attention_sharded(q[:, half].contiguous(), k[:, half]
                              .contiguous(), v[:, half].contiguous(), mesh)
    with open(f"{path}.rank{mesh.rank}") as f:
        lines = [json.loads(l) for l in f if l.strip()]
    return {"rows": rows,
            "series": {key: len(rec.series(key)) for key in (
                "ring_comm_s", "ring_attn_s", "ring_corr_s", "ring_grad_s")},
            "keys_after_two": keys_after_two,
            "keys": len(ra._RING_PROFILED), "lines": lines}


def case_cp_train(rank, world, state_path, batch_path, mk, layouts,
                  steps=3, lr=1e-3):
    """Each layout ``(name, mesh shape, config overrides, feed spec
    ("dp" or "dp_cp"), packed segments, optimizer options)`` trains
    ``steps`` Adam steps of the tiny model from the given (JAX) state on
    the global batch: its losses, gathered weights (rank 0) and the
    collectives of its first step."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.models import gpt as tgpt
    from hetu_tpu_torch.models import GPTLMHeadModel
    from hetu_tpu_torch.models.convert import load_state
    from hetu_tpu_torch.models.generate import _Params
    from hetu_tpu_torch.parallel import P, comm, create_mesh
    state = _dist_state(state_path)
    bt = np.load(batch_path)
    x, y, segs = bt["x"], bt["y"], bt["segs"]
    out = {}
    for name, shape, cfg_kw, feed, packed, opt_kw in layouts:
        mesh = create_mesh(shape, device="cpu")
        spec = P("dp", "cp") if feed == "dp_cp" else P("dp", None)
        cfg = getattr(tgpt, mk["fn"])(**{**mk["kw"], **cfg_kw})
        with ht.graph("define_and_run", create_new=True, mesh=mesh,
                      seed=0) as g:
            ids = ht.parallel_placeholder("int32", x.shape, pspec=spec,
                                          name="ids")
            labels = ht.parallel_placeholder("int32", y.shape, pspec=spec,
                                             name="labels")
            feeds = {ids: x, labels: y}
            seg_t = None
            if packed:
                seg_t = ht.parallel_placeholder("int32", segs.shape,
                                                pspec=spec, name="segs")
                feeds[seg_t] = segs
            model = GPTLMHeadModel(cfg)
            loss = model(ids, labels, segment_ids=seg_t)
            train_op = optim.AdamOptimizer(lr=lr, **opt_kw).minimize(loss)
        load_state(model, state)
        losses, records = [], None
        for i in range(steps):
            with comm.comm_stats() as st:
                l, _ = g.run(loss, [loss, train_op], feeds)
            losses.append(float(l))
            if i == 0:
                records = [tuple(r) for r in st.records]
        weights = {_Params._norm(n): g.global_value(p).numpy()
                   for n, p in model.named_parameters()}
        out[name] = {"losses": losses,
                     "weights": weights if rank == 0 else None,
                     "records": records,
                     "seq_axes": sorted(g.seq_axes)}
    return out


def _optimizer(optim, name, lr, kw):
    return {"adam": optim.AdamOptimizer, "sgd": optim.SGDOptimizer,
            "adafactor": optim.AdafactorOptimizer}[name](lr=lr, **kw)


def case_switch(rank, world, state_path, batch_path, cfg_kw, runs,
                lr=1e-3, micro=2):
    """Each run ``(name, mesh shape, sp, (optimizer, kwargs), phases)``
    builds the tiny model from the given (JAX) state on that mesh and
    walks ``phases``: ``(steps, next mesh shape or None, ranks or None,
    pending)``: trains ``steps`` steps, then (with ``pending``) adds one
    GRAD run's gradients, then switches the graph to the next mesh over
    ``ranks`` with the optimizer.  Returns each run's losses (None where
    the rank held no position), its profiles and the plan's counts for
    the same layouts, the switch's records, and the weights gathered by
    the first rank of the last mesh."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.models.convert import load_state
    from hetu_tpu_torch.models.generate import _Params
    from hetu_tpu_torch.parallel import P, comm, create_mesh
    state = _dist_state(state_path)
    b = np.load(batch_path)
    x, y = b["x"], b["y"]
    out = {}
    for name, shape, sp, (oname, okw), phases in runs:
        mesh = create_mesh(shape, device="cpu")
        with ht.graph("define_and_run", create_new=True, mesh=mesh,
                      seed=0) as g:
            ids = ht.parallel_placeholder("int32", x.shape,
                                          pspec=P("dp", None), name="ids")
            labels = ht.parallel_placeholder("int32", y.shape,
                                             pspec=P("dp", None),
                                             name="labels")
            model = GPTLMHeadModel(GPTConfig(**cfg_kw, sp=sp))
            loss = model(ids, labels)
            opt = _optimizer(optim, oname, lr, okw)
            train_op = opt.minimize(loss)
        load_state(model, state)
        feed = {ids: x, labels: y}
        losses, profiles = [], []
        with comm.comm_stats() as st:
            for steps, nxt, ranks, pending in phases:
                for _ in range(steps):
                    if not g.mesh.in_mesh:
                        losses.append(None)
                        continue
                    l, _ = g.run(loss, [loss, train_op], feed,
                                 num_micro_batches=micro)
                    losses.append(float(l))
                if pending and g.mesh.in_mesh:
                    g.run(loss, [loss, train_op], feed,
                          num_micro_batches=micro, run_level="grad")
                if nxt is not None:
                    sid = g.cur_strategy_id
                    prof = g.switch_strategy(
                        create_mesh(nxt, device="cpu", ranks=ranks),
                        optimizer=opt)
                    assert g.cur_strategy_id == sid + 1
                    profiles.append(prof.as_dict())
        weights = None
        if g.mesh.in_mesh:
            weights = {_Params._norm(n): g.global_value(p).numpy()
                       for n, p in model.named_parameters()}
            if rank != g.mesh.ranks[0]:
                weights = None
        out[name] = {"losses": losses, "weights": weights,
                     "profiles": profiles,
                     "switch_records": [tuple(r) for r in st.records
                                        if r.tag == "switch"],
                     "num_strategy": g.num_strategy}
    return out


def case_switch_values(rank, world, x, jobs):
    """``parallel.switch.switch_state`` of the global value ``x`` from
    each job's source layout to its destination layout, ``(name, (mesh
    shape, ranks, spec, blocks, units, chunk axis) twice, dtype)``: this
    rank's result and what it should hold (its pieces of ``x``), and the
    switch's records."""
    import torch
    from hetu_tpu_torch.parallel import comm
    from hetu_tpu_torch.parallel.switch import (Entry, Layout,
                                                SwitchProfile, switch_state)
    out = {}
    xt = torch.from_numpy(np.asarray(x))

    def layout(d):
        shape, ranks, spec, blocks, units, chunk = d
        return Layout(shape, ranks, spec, blocks=blocks, units=units,
                      chunk_axis=chunk)

    def local(lay):
        pieces = lay.pieces(xt.shape, rank)
        if not pieces:
            return None
        buf = torch.zeros(lay.local_shape(xt.shape, rank), dtype=xt.dtype)
        for gbox, lbox in pieces:
            buf[tuple(slice(a, b) for a, b in lbox)] = \
                xt[tuple(slice(a, b) for a, b in gbox)]
        return buf

    for name, src, dst, dtype in jobs:
        src, dst = layout(src), layout(dst)
        state = {} if local(src) is None else {"x": local(src)}
        prof = SwitchProfile()
        dt = getattr(torch, dtype) if dtype else None
        with comm.comm_stats() as st:
            got = switch_state(state, {"x": Entry(tuple(xt.shape), xt.dtype,
                                                  src, dst)},
                               dtype=dt, profile=prof, batch_bytes=64)["x"]
        want = local(dst)
        out[name] = {"got": None if got is None else got.float().numpy(),
                     "dtype": None if got is None else str(got.dtype),
                     "want": None if want is None else want.numpy(),
                     "consumed": not state,
                     "profile": prof.as_dict(),
                     "sent": prof.sent_bytes, "recv": prof.recv_bytes,
                     "records": [tuple(r) for r in st.records]}
    return out


def case_mesh_ranks(rank, world, layouts):
    """A mesh over chosen ranks, ``(shape, ranks)`` each: this rank's
    position, coordinates and groups, and over every axis an all-gather,
    a reduce-scatter and an all-to-all of values that name their axis
    index (what each rank gets, in axis order)."""
    import torch
    from hetu_tpu_torch.parallel import comm, create_mesh
    out = []
    for shape, ranks in layouts:
        mesh = create_mesh(shape, device="cpu", ranks=ranks)
        row = {"in_mesh": mesh.in_mesh, "position": mesh.position,
               "coords": dict(mesh.coords), "groups": {}}
        if mesh.in_mesh:
            for a in mesh.axis_names:
                n, i = mesh.axis_size(a), mesh.axis_index(a)
                x = torch.full((n,), float(i))
                row["groups"][a] = {
                    "ranks": mesh.group_ranks(a),
                    "gather": comm.all_gather(x[:1], a, 0, mesh).tolist(),
                    "scatter": comm.reduce_scatter(
                        torch.arange(float(n)) + 10 * i, a, 0, "sum",
                        mesh).tolist(),
                    "a2a": comm.all_to_all(torch.arange(float(n)) + 10 * i,
                                           a, 0, 0, mesh).tolist()}
        out.append(row)
    return out


def case_elastic(rank, world, state_path, jobs, batch=8, seq=16):
    """Each job ``(name, mesh shape, solver kwargs, script)`` builds the
    tiny GPT of tests/test_elastic.py from the given (JAX) state under an
    elastic ``Trainer`` and plays ``script``: ``("train", n)``,
    ``("retune", ratios or None)``, ``("env", ratios string)`` (the
    straggler ratios every rank reads), ``("run", steps, interval)`` and
    ``("tp_sharded",)``.  Returns what each step gave."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.elastic import StrategyModel, Trainer
    from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.models.convert import load_state
    from hetu_tpu_torch.parallel import P, create_mesh
    state = _dist_state(state_path)
    out = {}
    for name, shape, solver_kw, script in jobs:
        cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                        num_heads=4, max_seq_len=seq, dtype="float32")
        mesh = create_mesh(shape, device="cpu")
        with ht.graph("define_and_run", create_new=True, mesh=mesh,
                      seed=0) as g:
            ids = ht.parallel_placeholder("int32", (batch, seq),
                                          pspec=P("dp", None), name="ids")
            labels = ht.parallel_placeholder("int32", (batch, seq),
                                             pspec=P("dp", None),
                                             name="labels")
            model = GPTLMHeadModel(cfg)
            loss = model(ids, labels)
            opt = optim.AdamOptimizer(lr=1e-2)
            train_op = opt.minimize(loss)
        load_state(model, state)
        IDS = np.random.RandomState(0).randint(0, 64, (batch, seq)).astype(
            np.int32)
        feed = {ids: IDS, labels: np.roll(IDS, -1, 1)}
        trainer = Trainer(g, loss, train_op, opt, lambda step: feed,
                          StrategyModel(num_devices=world, **solver_kw),
                          num_micro_batches=2)
        got = []
        for op in script:
            if op[0] == "train":
                got.append(trainer.train_steps(op[1]))
            elif op[0] == "retune":
                got.append(trainer.retune(op[1]))
            elif op[0] == "tp_candidates":
                trainer.solver.tp_candidates = op[1]
            elif op[0] == "env":
                os.environ["HETU_TPU_STRAGGLER_RATIOS"] = op[1]
            elif op[0] == "run":
                got.append(trainer.run(op[1], profile_interval=op[2]))
            elif op[0] == "tp_sharded":
                got.append(any(tuple(t.shape) != tuple(t.global_shape)
                               for t in g.trainable_variables
                               if t.global_shape is not None))
        os.environ.pop("HETU_TPU_STRAGGLER_RATIOS", None)
        out[name] = {"got": got,
                     "history": [h["strategy"] for h in trainer.history],
                     "strategy": trainer.current_strategy.describe()
                     if trainer.current_strategy else None,
                     "mesh": dict(g.mesh.shape), "ranks": list(g.mesh.ranks)}
    return out


FT_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=16, dtype="float32", sp=False)


def ft_build_fn(state, table, sentry=True, opt_kw=None, batch=8):
    """The fault-tolerant trainer's ``build_fn`` of tests/test_torch_ft.py
    and tests/test_torch_resilience.py: the tiny GPT from the given (JAX)
    state on ``{"dp": dp}`` over ``ranks[:dp]``, Adam with flat ZeRO-2
    and the sentry; ``step_fn(cursor)`` trains on ``table[cursor]``."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import optim
    from hetu_tpu_torch.elastic import TrainBuild
    from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.models.convert import load_state
    from hetu_tpu_torch.parallel import P, create_mesh
    kw = dict(lr=1e-2, zero=2, grad_comm="fp32", flat_state=True)
    kw.update(opt_kw or {})

    def build(dp, ranks):
        mesh = create_mesh({"dp": dp}, device="cpu", ranks=list(ranks)[:dp])
        with ht.graph("define_and_run", create_new=True, mesh=mesh,
                      seed=0) as g:
            ids = ht.parallel_placeholder("int32", (batch, 16),
                                          pspec=P("dp", None), name="ids")
            labels = ht.parallel_placeholder("int32", (batch, 16),
                                             pspec=P("dp", None),
                                             name="labels")
            model = GPTLMHeadModel(GPTConfig(**FT_CFG))
            loss = model(ids, labels)
            opt = optim.AdamOptimizer(sentry=sentry, **kw)
            train_op = opt.minimize(loss)
        if mesh.in_mesh:
            load_state(model, state)

        def step_fn(cursor):
            b = table[cursor][:batch]
            out = g.run(loss, [loss, train_op],
                        {ids: b, labels: np.roll(b, -1, axis=1)})
            return float(out[0])

        return TrainBuild(graph=g, model=model, optimizer=opt,
                          step_fn=step_fn)
    return build


def _local_weights(model):
    return {n: p.graph.get_tensor_value(p).detach().clone().numpy()
            for n, p in model.named_parameters()}


def case_ft(rank, world, state_path, table_path, ckdir, events, steps,
            trainer_kw, ttl=3.0):
    """The ``FaultTolerantTrainer`` on every rank with a ``WorkerMonitor``
    of one worker a rank, under the fault plan ``events`` ((step, kind,
    target) each); then a fault-free run of the world's layout on the
    committed cursors.  Returns the losses, counters, recoveries, cursors,
    the generations left on disk and the reference losses."""
    from hetu_tpu_torch.elastic import (FaultTolerantTrainer, WorkerMonitor,
                                        write_recovery_report)
    from hetu_tpu_torch.fault import FaultEvent, FaultPlan
    from hetu_tpu_torch.resilience import (list_generations,
                                           verify_generation)
    from hetu_tpu_torch.resilience.generations import generation_dir
    state = _dist_state(state_path)
    table = np.load(table_path)
    build = ft_build_fn(state, table)
    mon = WorkerMonitor(world, list(range(world)), ttl=ttl,
                        heartbeat_interval=0.05)
    tr = FaultTolerantTrainer(build, list(range(world)), monitor=mon,
                              checkpoint_dir=ckdir, **trainer_kw)
    plan = FaultPlan(events=[FaultEvent(step=s, kind=k, target=t)
                             for s, k, t in events])
    losses = tr.train(steps, fault_plan=plan)
    out = {"losses": losses, "metrics": tr.metrics_summary(),
           "metrics_text": tr.metrics_text(),
           "recoveries": [{k: v for k, v in r.items()
                           if not k.endswith("_s") and k not in
                           ("killed_at", "_t0")} for r in tr.recoveries],
           "mttr": [r.get("mttr_s") for r in tr.recoveries],
           "cursors": tr.committed_cursors(),
           "burned": list(tr.burned_cursors), "dp": tr.dp,
           "in_mesh": tr.build.graph.mesh.in_mesh,
           "ck_steps": list(tr._ck_steps),
           "host_reads": tr.build.optimizer.sentry.host_reads
           if tr.build.graph.mesh.in_mesh else None,
           "attempts": tr.attempts,
           "generations": {s: verify_generation(
               generation_dir(ckdir, s))[0] for s in list_generations(ckdir)},
           "report": write_recovery_report(
               tr, os.path.join(ckdir, f"report.{rank}.json"))}
    tr.close()
    mon.close()
    ref = build(world, list(range(world)))
    out["ref_losses"] = [ref.step_fn(c) for c in out["cursors"]]
    return out


def case_sentry_flat(rank, world, state_path, table_path):
    """tests/test_resilience.py's flat ZeRO-2 skip on ``world`` ranks: a
    grad_spike at step 2 is skipped (the step counter stays), the clean
    steps equal a run that never saw it, bitwise, in losses and weights."""
    state = _dist_state(state_path)
    table = np.load(table_path)
    build = ft_build_fn(state, table, opt_kw={"max_grad_norm": 1.0})
    b = build(world, list(range(world)))
    st = b.optimizer._state
    losses = [b.step_fn(0), b.step_fn(1)]
    counters = [float(st["step"])]
    b.graph.inject_numeric_fault("grad_spike")
    spiked = b.step_fn(2)
    verdict = b.optimizer.sentry.last_verdict()
    counters.append(float(st["step"]))
    losses.append(b.step_fn(3))
    counters.append(float(st["step"]))
    chaos = _local_weights(b.model)
    ref = build(world, list(range(world)))
    ref_losses = [ref.step_fn(c) for c in (0, 1, 3)]
    same = all(np.array_equal(chaos[k], v)
               for k, v in _local_weights(ref.model).items())
    return {"losses": losses, "ref_losses": ref_losses, "spiked": spiked,
            "verdict": verdict, "step_counter": counters,
            "ref_step_counter": float(ref.optimizer._state["step"]),
            "weights_bitwise": same}


def case_sentry_agree(rank, world, state_path, table_path):
    """Faults injected on ONE rank: a loss spike only rank 0's local loss
    shows (x64, about half of which survives the dp mean), judged against
    a factor 20 (the reduced loss fails: skipped, the EMA kept) and then
    40 (it passes), and a NaN gradient on the last rank only.  Every rank
    must take the same verdict and hold the same weights."""
    import dataclasses
    state = _dist_state(state_path)
    table = np.load(table_path)
    b = ft_build_fn(state, table)(world, list(range(world)))
    sentry = b.optimizer.sentry
    sentry.config = dataclasses.replace(sentry.config, loss_spike_factor=40.0)
    for c in range(4):
        b.step_fn(c)
    verdicts = []
    for c, kind, who, factor in ((4, "loss_spike", 0, 20.0),
                                 (5, "loss_spike", 0, 40.0),
                                 (6, "grad_nan", world - 1, 20.0)):
        sentry.config = dataclasses.replace(sentry.config,
                                            loss_spike_factor=factor)
        if rank == who:
            b.graph.inject_numeric_fault(kind)
        b.step_fn(c)
        verdicts.append(sentry.last_verdict())
    return {"verdicts": verdicts,
            "step_counter": float(b.optimizer._state["step"]),
            "weights": _local_weights(b.model)}


def case_bg_save(rank, world, state_path, table_path, out_dir,
                 coordinator):
    """A background save from every rank of a flat ZeRO-2 dp ``world``
    model after 2 steps, a third step trained while it writes; with
    ``coordinator`` the ranks' writer threads meet at the coordinator's
    barriers, without one it is refused.  Returns the gathered weights at
    the save and the error text."""
    import torch.distributed as dist
    from hetu_tpu_torch.parallel import comm
    from hetu_tpu_torch.rpc.coordinator import (CoordinatorClient,
                                                CoordinatorServer)
    from hetu_tpu_torch.utils.checkpoint import save_checkpoint
    state = _dist_state(state_path)
    table = np.load(table_path)
    b = ft_build_fn(state, table, sentry=False)(world, list(range(world)))
    b.step_fn(0)
    b.step_fn(1)
    want = {n: b.graph.global_value(p).numpy().copy()
            for n, p in b.model.named_parameters()}
    server, client = None, None
    if coordinator:
        if rank == 0:
            server = CoordinatorServer(world_size=world).start()
        box = [server.address if rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        client = CoordinatorClient(box[0], uid=f"rank{rank}")
        client.connect()
        client.world_size = world
    comm.set_coordinator(client)
    error = None
    try:
        h = save_checkpoint(b.model, b.optimizer, out_dir, step=2,
                            background=True)
        b.step_fn(2)                 # trains while the writer runs
        h.wait(timeout=120)
    except RuntimeError as e:
        error = str(e)
    finally:
        comm.set_coordinator(None)
    dist.barrier()
    if client is not None:
        client.close()
    if server is not None:
        server.stop()
    return {"weights": want if rank == 0 else None, "error": error}


CASES = {"collectives": case_collectives, "switch": case_switch,
         "elastic": case_elastic, "switch_values": case_switch_values,
         "mesh_ranks": case_mesh_ranks, "train_many": case_train_many,
         "grad_comm_routing": case_grad_comm_routing,
         "cp_attention": case_cp_attention, "ring_profile": case_ring_profile,
         "cp_train": case_cp_train,
         "pipeline": case_pipeline, "permute": case_permute,
         "pipeline_feed_refusal": case_pipeline_feed_refusal,
         "aux": case_aux,
         "many": case_many,
         "stats": case_stats, "checkpoint": case_checkpoint, "ce": case_ce,
         "ft": case_ft, "sentry_flat": case_sentry_flat,
         "sentry_agree": case_sentry_agree, "bg_save": case_bg_save}


def main(argv):
    rank, world = int(argv[1]), int(argv[2])
    init, case, arg_path, out = argv[3], argv[4], argv[5], argv[6]
    sys.path.insert(0, REPO)
    import torch
    torch.set_num_threads(1)
    from hetu_tpu_torch.parallel import init_process_group
    init_process_group(rank, world, f"file://{init}", device="cpu",
                       timeout=60.0)
    with open(arg_path, "rb") as f:
        args = pickle.load(f)
    result = CASES[case](rank, world, **args)
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
