"""The port's launcher, ``distributed_init`` and the multi-process split
checkpoint, on the CPU.

- ``Launcher`` spawns workers with the JAX launcher's environment,
  restarts a crashed worker within its budget and gives up after it (the
  cases of tests/test_rpc.py, there marked slow; here each worker is a
  short interpreter and every wait has a timeout);
- ``distributed_init``: two launched workers meet through the
  coordinator, join a gloo group on the address rank 0 published, and
  all-reduce and barrier through it; four workers that name two hosts
  get their local ranks from the host records the coordinator gathers,
  and the backend rule reads those records (NCCL when each host has a
  card a rank, whatever the world size);
- a split checkpoint written by two port ranks (tp 2: the fused qkv
  split block by block, each rank its own file) loads into the JAX
  package, which takes the next Adam step; its checkpoint loads into two
  port ranks (dp 2, ZeRO-2: the moments chunked over dp), whose next
  step equals the JAX package's (losses 2e-5, weights 1e-5).
"""
import json
import os
import sys

import numpy as np

import hetu_tpu as jht
from hetu_tpu import optim as joptim
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPTLMHeadModel
from hetu_tpu.models.generate import _Params as JParams
from hetu_tpu.utils import checkpoint as jckpt
from hetu_tpu_torch.rpc import Launcher
from torch_ranks import REPO, checkpoint_batch, run_ranks

KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
          max_seq_len=16, sp=False, dropout=0.0)

WORKER = r"""
import os, sys
sys.path.insert(0, {repo!r})
from hetu_tpu_torch.rpc.launcher import worker_client
c = worker_client()
n = int(os.environ["HETU_TPU_NUM_WORKERS"])
c.put(f"hello/{{c.rank}}", os.environ["HETU_TPU_WORKER_RANK"])
c.barrier("all", world_size=n, timeout=30)
vals = [c.get(f"hello/{{r}}", timeout=10) for r in range(n)]
assert all(v is not None for v in vals), vals
c.exit()
"""


def test_launcher_local_workers(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO))
    with Launcher([sys.executable, str(script)], num_workers=3) as l:
        assert l.monitor(poll=0.05, timeout=60) == 3


def test_launcher_restart_policy(tmp_path):
    """A worker that crashes on its first attempt is restarted."""
    script = tmp_path / "flaky.py"
    script.write_text(
        "import os, sys\n"
        f"marker = {str(tmp_path)!r} + '/died-' + "
        "os.environ['HETU_TPU_WORKER_RANK']\n"
        "if not os.path.exists(marker):\n"
        "    open(marker, 'w').close()\n"
        "    sys.exit(1)\n")
    with Launcher([sys.executable, str(script)], num_workers=2,
                  max_restart_times=2) as l:
        assert l.monitor(poll=0.05, timeout=60) == 2
    assert any(e["event"] == "restart" for e in l.events)


def test_launcher_gives_up_after_budget(tmp_path):
    script = tmp_path / "dead.py"
    script.write_text("import sys; sys.exit(3)\n")
    with Launcher([sys.executable, str(script)], num_workers=1,
                  max_restart_times=1) as l:
        assert l.monitor(poll=0.05, timeout=60) == 0
    assert any(e["event"] == "gave_up" for e in l.events)
    assert sum(1 for e in l.events if e["event"] == "restart") == 1


RENDEZVOUS = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from hetu_tpu_torch.parallel import comm, create_mesh
from hetu_tpu_torch.rpc import distributed_init
addr = os.environ["HETU_TPU_COORDINATOR"]
c = distributed_init(addr, 2, device="cpu", uid="w" +
                     os.environ["HETU_TPU_WORKER_RANK"], timeout=30.0)
mesh = create_mesh({{"dp": 2}}, device="cpu")
x = torch.full((3,), float(c.rank + 1))
s = comm.all_reduce(x, "dp", mesh=mesh)
comm.barrier(name="after")
with open(os.path.join({out!r}, f"rank{{c.rank}}.json"), "w") as f:
    json.dump({{"rank": c.rank, "sum": s.tolist(), "backend": mesh.backend,
               "world": c.world_size}}, f)
import torch.distributed as dist
dist.destroy_process_group()
c.exit()
"""


def test_distributed_init_rendezvous(tmp_path):
    script = tmp_path / "rdv.py"
    script.write_text(RENDEZVOUS.format(repo=REPO, out=str(tmp_path)))
    with Launcher([sys.executable, str(script)], num_workers=2) as l:
        assert l.monitor(poll=0.05, timeout=90) == 2
    got = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    assert [g["rank"] for g in got] == [0, 1]
    for g in got:
        assert g["sum"] == [3.0, 3.0, 3.0]
        assert g["backend"] == "gloo" and g["world"] == 2


TWO_HOSTS = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from hetu_tpu_torch.parallel import choose_backend, create_mesh, mesh
from hetu_tpu_torch.rpc import distributed_init
w = int(os.environ["HETU_TPU_WORKER_RANK"])
c = distributed_init(os.environ["HETU_TPU_COORDINATOR"], 4, device="cpu",
                     uid=f"w{{w}}", hostname="host" + "AB"[w % 2],
                     timeout=30.0)
m = create_mesh({{"dp": 4}}, device="cpu")
hosts = [c.get_device_info(r) for r in range(4)]
with open(os.path.join({out!r}, f"rank{{c.rank}}.json"), "w") as f:
    json.dump({{"rank": c.rank, "host": c.hostname, "hosts": hosts,
               "local": mesh._LOCAL_RANK[0], "backend": m.backend,
               "cuda_1": choose_backend([(h, 1) for h, _ in hosts]),
               "cuda_2": choose_backend([(h, 2) for h, _ in hosts])}}, f)
import torch.distributed as dist
dist.destroy_process_group()
c.exit()
"""


def test_distributed_init_two_hosts(tmp_path):
    script = tmp_path / "hosts.py"
    script.write_text(TWO_HOSTS.format(repo=REPO, out=str(tmp_path)))
    with Launcher([sys.executable, str(script)], num_workers=4) as l:
        assert l.monitor(poll=0.05, timeout=90) == 4
    got = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(4)]
    hosts = [h for h, _ in got[0]["hosts"]]
    assert sorted(hosts) == ["hostA", "hostA", "hostB", "hostB"]
    for g in got:
        assert [h for h, _ in g["hosts"]] == hosts
        assert hosts[g["rank"]] == g["host"]
        # the place among the ranks of its own host, not the global rank
        assert g["local"] == hosts[:g["rank"]].count(g["host"])
        assert g["backend"] == "gloo"
        assert g["cuda_1"] == "gloo" and g["cuda_2"] == "nccl"


def test_backend_rule_counts_ranks_a_host():
    from hetu_tpu_torch.parallel.mesh import choose_backend, local_rank
    four_hosts = [(f"h{i}", 1) for i in range(4)]
    assert choose_backend(four_hosts) == "nccl"
    assert [local_rank(four_hosts, r) for r in range(4)] == [0] * 4
    two_by_four = [("a", 4)] * 4 + [("b", 4)] * 4
    assert choose_backend(two_by_four) == "nccl"
    assert [local_rank(two_by_four, r) for r in range(8)] == \
        [0, 1, 2, 3, 0, 1, 2, 3]
    interleaved = [("a", 2), ("b", 2), ("a", 2), ("b", 2)]
    assert [local_rank(interleaved, r) for r in range(4)] == [0, 0, 1, 1]
    assert choose_backend([("a", 1)] * 2) == "gloo"
    assert choose_backend([("a", 2), ("a", 2), ("b", 1), ("b", 1)]) == \
        "gloo"
    assert choose_backend(four_hosts, device="cpu") == "gloo"


class _Jax:
    def __init__(self, state=None):
        with jht.graph("define_and_run", create_new=True) as g:
            x, y = checkpoint_batch(KW["vocab_size"])
            self.ids = jht.placeholder("int32", x.shape)
            self.labels = jht.placeholder("int32", y.shape)
            self.model = JaxGPTLMHeadModel(JaxGPTConfig(**KW))
            self.loss = self.model(self.ids, self.labels)
            self.opt = joptim.AdamOptimizer(lr=1e-3)
            self.op = self.opt.minimize(self.loss)
            if state is not None:
                self.model.load_state_dict(state)
        self.g = g

    def step(self):
        x, y = checkpoint_batch(KW["vocab_size"])
        return float(np.asarray(self.g.run(
            self.loss, [self.loss, self.op],
            {self.ids: x, self.labels: y})[0]))

    def params(self):
        return {JParams._norm(k): np.asarray(v, np.float32)
                for k, v in self.model.state_dict().items()}


def _close(got, want, atol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


def test_split_checkpoint_crosses_both_ways(tmp_path):
    jht.set_seed(11)
    with jht.graph("eager", create_new=True):
        m = JaxGPTLMHeadModel(JaxGPTConfig(**KW))
        m.logits(np.zeros((1, 4), np.int32))
        state = {k: np.asarray(v) for k, v in m.state_dict().items()}
    np.savez(tmp_path / "state.npz", **state)
    port_dir, jax_dir, again = (str(tmp_path / d)
                                for d in ("port", "jax", "again"))
    # two tp ranks train a step and save their halves
    p1 = run_ranks("checkpoint", 2, dict(
        cfg_kw=KW, mesh_shape={"tp": 2}, save_dir=port_dir,
        state_path=str(tmp_path / "state.npz")), tmp_path)
    assert p1[0]["loss"] == p1[1]["loss"]
    files = sorted(f for f in os.listdir(port_dir)
                   if f.endswith(".safetensors"))
    assert files == ["model_00000-of-00002.safetensors",
                     "model_00001-of-00002.safetensors"]
    index = json.load(open(os.path.join(port_dir, "index.json")))
    qkv = index["tensors"]["transformer.h.0.attn.qkv.weight"]
    assert len(qkv["slices"]) == 6         # q, k, v blocks of each rank
    # the JAX package loads them and takes the same first step's weights
    j = _Jax()
    assert jckpt.load_checkpoint(j.model, j.opt, port_dir,
                                 verify_exempt=True)["step"] == 1
    _close(j.params(), p1[0]["weights"], 0)
    # JAX steps on and saves; two dp ranks under ZeRO-2 load and step on
    j.step()
    jckpt.save_checkpoint(j.model, j.opt, jax_dir, step=2)
    p2 = run_ranks("checkpoint", 2, dict(
        cfg_kw=KW, mesh_shape={"dp": 2}, opt_kw={"zero": 2},
        save_dir=again, load_dir=jax_dir), tmp_path)
    jl = j.step()
    assert abs(p2[0]["loss"] - jl) <= 2e-5
    _close(p2[0]["weights"], j.params(), 1e-5)
