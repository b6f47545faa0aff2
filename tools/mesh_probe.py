"""What each backend of ``torch.distributed`` takes when several ranks
share one card.

    python3 tools/mesh_probe.py [--out FILE]

Starts 2 rank processes on card 0 over gloo and tries every collective
the port's ``parallel.comm`` issues on CUDA tensors (all-reduce,
all-gather into a tensor, reduce-scatter of a tensor, all-to-all of one
tensor, broadcast, send/recv), each against its expected result; then
starts 2 ranks over NCCL on the same card and reports how the group's
first collective fails.  Prints one JSON line (also written to
``--out``): for gloo, each op's ``ok`` or its error; for NCCL, the error
text.  Every rank has a 60 s timeout and is killed after it.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

RANK = r"""
import datetime, json, sys
import torch, torch.distributed as dist
rank, backend, init = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.cuda.set_device(0)
kw = {"device_id": torch.device("cuda", 0)} if backend == "nccl" else {}
out = {}
try:
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=60), **kw)
except Exception as e:  # report how the group refuses
    print(json.dumps({"init": f"{type(e).__name__}: {e}"[:600]}))
    sys.exit(0)
x = torch.arange(8, dtype=torch.float32, device="cuda") + 10 * rank
ar = torch.arange(8.)


def all_reduce():
    y = x.clone()
    dist.all_reduce(y)
    return y.tolist() == (2 * ar + 10).tolist()


def all_gather():
    z = torch.empty(16, device="cuda")
    dist.all_gather_into_tensor(z, x)
    return z.tolist() == ar.tolist() + (ar + 10).tolist()


def reduce_scatter():
    z = torch.empty(4, device="cuda")
    dist.reduce_scatter_tensor(z, x)
    return z.tolist() == (2 * ar + 10)[4 * rank:4 * rank + 4].tolist()


def all_to_all():
    z = torch.empty(8, device="cuda")
    dist.all_to_all_single(z, x)
    return z.tolist() == [float(4 * rank + i + 10 * j) for j in range(2)
                          for i in range(4)]


def broadcast():
    y = x.clone()
    dist.broadcast(y, src=1)
    return y.tolist() == (ar + 10).tolist()


def ppermute():
    y = torch.empty(8, device="cuda")
    for req in dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, x, 1 - rank),
             dist.P2POp(dist.irecv, y, 1 - rank)]):
        req.wait()
    return y.tolist() == (ar + 10 * (1 - rank)).tolist()


ops = {"all_reduce": all_reduce, "all_gather": all_gather,
       "reduce_scatter": reduce_scatter, "all_to_all": all_to_all,
       "broadcast": broadcast, "ppermute": ppermute}
for name, fn in ops.items():
    try:
        ok = fn()
        torch.cuda.synchronize()
        out[name] = "ok" if ok else "wrong result"
    except Exception as e:
        out[name] = f"{type(e).__name__}: {e}"[:300]
print(json.dumps(out))
dist.destroy_process_group()
"""


def run(backend: str, tmp: str) -> list:
    init = "file://" + os.path.join(tmp, f"init_{backend}")
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), backend,
                               init], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=90)
            lines = [l for l in out.splitlines() if l.startswith("{")]
            outs.append(json.loads(lines[-1]) if lines else
                        {"exit": p.returncode, "stderr": err[-600:]})
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            outs.append({"timeout": 90})
    return outs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        res = {"torch": torch.__version__, "cuda": torch.version.cuda,
               "device_count": torch.cuda.device_count(),
               "gloo_cuda": run("gloo", tmp), "nccl_two_ranks_one_card":
               run("nccl", tmp)}
    line = json.dumps(res)
    print(line)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
