"""The port's mesh training (TP, SP, DP with ZeRO 0-3, flat state and the
explicit fp32 grad-comm path) against the JAX package, on the CPU.

A tiny GPT-2 and a tiny LLaMA (2 layers, hidden 32, 4 heads, vocab 64,
fp32; the LLaMA with SwiGLU and 2 KV heads, the GPT-2 with the fused qkv
bias) are built by the JAX model, and one JAX state dict is carried into
the port (``models.convert.load_state`` takes global values; each rank
keeps its shard).  Four gloo ranks (tests/torch_ranks.py) train every
layout 3 Adam steps (lr 1e-3, 2 micro-batches) on one global batch whose
labels carry ``-100`` padding in uneven amounts per row, and gather the
weights (``Graph.global_value``).  A layout of 2 ranks runs as two
replicas over a mesh axis no parameter names (``r``).  Each layout's
losses must be within 2e-5 of the JAX package's single-device run and
its gathered weights within 1e-5; ZeRO-1/2/3 and flat state equal ZeRO-0
in the port bitwise.

lr is 1e-3 because the k bias of the fused qkv has an exactly zero
gradient (softmax ignores a shift of every score): Adam turns its
rounding noise into steps of up to lr, so at lr 1e-2 two correct
summation orders part there by 3e-5.
"""
import time

import numpy as np
import pytest

import hetu_tpu as jht
from hetu_tpu import optim as joptim
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPTLMHeadModel
import torch

import hetu_tpu_torch as ht
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
from hetu_tpu_torch.models.convert import (gather_state, load_state,
                                           shard_state)
from hetu_tpu_torch.models.generate import _Params
from hetu_tpu_torch.parallel import P
from torch_ranks import run_ranks

LR, STEPS, MICRO = 1e-3, 3, 2
B, S = 4, 16
BASE = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=64, dropout=0.0)
CONFIGS = {
    "gpt2": dict(BASE, position="learned", norm="layernorm",
                 activation="gelu"),
    "llama": dict(BASE, position="rotary", norm="rmsnorm",
                  activation="swiglu", num_kv_heads=2),
}
R2 = {"r": 2}       # two replicas of a 2-rank layout over 4 ranks
CLIP = 0.5          # below the tiny models' gradient norms
LAYOUTS = [
    ("dp2", {**R2, "dp": 2}, False, {}),
    ("dp2_zero1", {**R2, "dp": 2}, False, {"zero": 1}),
    ("dp2_zero2", {**R2, "dp": 2}, False, {"zero": 2}),
    ("dp2_zero3", {**R2, "dp": 2}, False, {"zero": 3}),
    ("dp2_grad_comm_fp32", {**R2, "dp": 2}, False, {"grad_comm": "fp32"}),
    ("dp2_flat_zero2", {**R2, "dp": 2}, False,
     {"zero": 2, "grad_comm": "fp32", "flat_state": True}),
    ("dp2_flat_zero3", {**R2, "dp": 2}, False,
     {"zero": 3, "grad_comm": "fp32", "flat_state": True}),
    ("tp2", {**R2, "tp": 2}, False, {}),
    ("tp2_sp", {**R2, "tp": 2}, True, {}),
    ("dp2_tp2", {"dp": 2, "tp": 2}, False, {}),
    ("dp2_tp2_sp", {"dp": 2, "tp": 2}, True, {}),
    ("dp2_tp2_sp_zero3", {"dp": 2, "tp": 2}, True, {"zero": 3}),
    # the global-norm clip: every parameter counted once over tp and dp
    ("dp2_tp2_sp_clip", {"dp": 2, "tp": 2}, True, {"max_grad_norm": CLIP}),
    ("dp2_zero2_clip", {**R2, "dp": 2}, False,
     {"zero": 2, "max_grad_norm": CLIP}),
    ("dp2_flat_zero2_clip", {**R2, "dp": 2}, False,
     {"zero": 2, "grad_comm": "fp32", "flat_state": True,
      "max_grad_norm": CLIP}),
    # tp above the LLaMA's 2 kv heads: the heads repeat over the ranks
    ("tp4", {"tp": 4}, False, {}),
    ("tp4_sp_clip", {"tp": 4}, True, {"max_grad_norm": CLIP}),
]
ZERO_PEERS = ["dp2_zero1", "dp2_zero2", "dp2_zero3", "dp2_flat_zero2",
              "dp2_flat_zero3"]


def _batch():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 64, (B, S)).astype(np.int32)
    y = rng.randint(0, 64, (B, S)).astype(np.int32)
    y[0, :5] = -100          # uneven valid counts across the dp shards
    y[3, 2:] = -100
    return x, y


def _jax_state(kw):
    jht.set_seed(7)
    with jht.graph("eager", create_new=True):
        model = JaxGPTLMHeadModel(JaxGPTConfig(**kw))
        model.logits(np.zeros((1, 4), np.int32))
        return {k: np.asarray(v) for k, v in model.state_dict().items()}


def _jax_run(kw, state, x, y, mesh=None, sp=False, clip=None):
    """JAX's run of the same model: 3 Adam steps; losses and weights
    (normalised names)."""
    from hetu_tpu.models.generate import _Params as JParams
    from jax.sharding import PartitionSpec as JP
    with jht.graph("define_and_run", create_new=True, mesh=mesh) as g:
        spec = JP("dp", None) if mesh is not None else None
        ids = jht.parallel_placeholder("int32", (B, S), pspec=spec)
        labels = jht.parallel_placeholder("int32", (B, S), pspec=spec)
        model = JaxGPTLMHeadModel(JaxGPTConfig(**kw, sp=sp))
        loss = model(ids, labels)
        op = joptim.AdamOptimizer(lr=LR, max_grad_norm=clip).minimize(loss)
        model.load_state_dict(state)
    losses = [float(np.asarray(g.run(loss, [loss, op], {ids: x, labels: y},
                                     num_micro_batches=MICRO)[0]))
              for _ in range(STEPS)]
    weights = {JParams._norm(k): np.asarray(v, np.float32)
               for k, v in model.state_dict().items()}
    return losses, weights


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every layout of both models on 4 gloo ranks (one launch), and the
    JAX package's single-device runs."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    x, y = _batch()
    np.savez(tmp / "batch.npz", x=x, y=y)
    out = {}
    for name, kw in CONFIGS.items():
        state = _jax_state(kw)
        np.savez(tmp / f"state_{name}.npz", **state)
        out[name] = {"jax": _jax_run(kw, state, x, y),
                     "jax_clip": _jax_run(kw, state, x, y, clip=CLIP),
                     "state": state}
    jobs = {name: dict(state_path=str(tmp / f"state_{name}.npz"),
                       batch_path=str(tmp / "batch.npz"), cfg_kw=kw,
                       layouts=LAYOUTS, lr=LR, steps=STEPS, micro=MICRO)
            for name, kw in CONFIGS.items()}
    res = run_ranks("train_many", 4, {"jobs": jobs}, tmp, timeout=240.0)
    for name in CONFIGS:
        out[name]["port"] = [r[name] for r in res]
    return out


@pytest.mark.parametrize("model", sorted(CONFIGS))
@pytest.mark.parametrize("layout", [lay[0] for lay in LAYOUTS])
def test_layout_matches_jax_single_device(runs, model, layout):
    jl, jw = runs[model]["jax_clip" if layout.endswith("_clip") else "jax"]
    r0 = runs[model]["port"][0][layout]
    # every rank saw the same (global) loss
    for r in runs[model]["port"]:
        assert r[layout]["losses"] == r0["losses"]
        assert not r[layout]["captured"]          # gloo: eager
    assert max(abs(a - b) for a, b in zip(r0["losses"], jl)) <= 2e-5
    assert r0["losses"][-1] < r0["losses"][0]
    assert set(r0["weights"]) == set(jw)
    for k, v in jw.items():
        assert r0["weights"][k].shape == v.shape, k
        np.testing.assert_allclose(r0["weights"][k], v, rtol=0, atol=1e-5,
                                   err_msg=f"{layout} {k}")


@pytest.mark.parametrize("model", sorted(CONFIGS))
def test_zero_levels_and_flat_state_match_zero0(runs, model):
    """ZeRO-1/2/3 and the flat layout equal ZeRO-0 in the port, bitwise
    (so within any 1e-6): the fp32 all-reduce and reduce-scatter add the
    two ranks' terms in one order, ZeRO-3 reduce-scatters the gradient
    summed over the micro-batches as ZeRO-2 does, and the update math is
    elementwise."""
    base = runs[model]["port"][0]["dp2"]
    for peer in ZERO_PEERS:
        r = runs[model]["port"][0][peer]
        assert r["losses"] == base["losses"], peer
        for k, v in base["weights"].items():
            np.testing.assert_array_equal(r["weights"][k], v,
                                          err_msg=f"{peer} {k}")


def test_zero_levels_record_their_collectives(runs):
    """ZeRO-2 reduce-scatters what ZeRO-1 all-reduces; ZeRO-3 gathers its
    parameters each micro-batch (``param_gather``) and gathers none after
    the update; flat state issues one chain a bucket."""
    recs = {lay: runs["gpt2"]["port"][0][lay]["records"]
            for lay in ("dp2", "dp2_zero1", "dp2_zero2", "dp2_zero3",
                        "dp2_flat_zero2")}

    def kinds(lay, tag):
        return sorted({r[0] for r in recs[lay] if r[5].startswith(tag)})
    assert kinds("dp2", "grad_sync") == ["all_reduce"]
    assert kinds("dp2_zero1", "param_comm") == ["all_gather"]
    assert "reduce_scatter" in kinds("dp2_zero2", "grad_sync")
    assert kinds("dp2_zero3", "param_comm") == []
    assert kinds("dp2_zero3", "param_gather") == ["all_gather"]
    assert kinds("dp2_flat_zero2", "grad_comm") == ["reduce_scatter"]
    assert kinds("dp2_flat_zero2", "param_comm") == ["all_gather"]


def test_dp2_tp2_sp_matches_the_jax_mesh_run(runs, devices8):
    """One layout against the JAX package's own dp 2 x tp 2 mesh with
    sequence parallelism, on 4 virtual devices."""
    from hetu_tpu.parallel import create_mesh
    kw = CONFIGS["llama"]
    x, y = _batch()
    t0 = time.time()
    mesh = create_mesh({"dp": 2, "tp": 2}, devices8[:4])
    jl, jw = _jax_run(kw, runs["llama"]["state"], x, y, mesh=mesh, sp=True)
    r0 = runs["llama"]["port"][0]["dp2_tp2_sp"]
    assert max(abs(a - b) for a, b in zip(r0["losses"], jl)) <= 2e-5
    for k, v in jw.items():
        np.testing.assert_allclose(r0["weights"][k], v, rtol=0, atol=1e-5,
                                   err_msg=k)
    assert time.time() - t0 < 60


class _Position:
    """A mesh position that builds a model (no process group: nothing
    runs)."""

    def __init__(self, shape, coords):
        self.axis_names, self.shape, self.coords = tuple(shape), shape, coords
        self.size, self.rank, self.backend = 4, 0, None
        self.device = torch.device("cpu")

    def axis_size(self, axis):
        return self.shape.get(axis, 1)

    def axis_index(self, axis):
        return self.coords.get(axis, 0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def _build(kw, pos, **over):
    with ht.graph("define_and_run", create_new=True, mesh=pos,
                  device="cpu") as g:
        ids = ht.parallel_placeholder("int32", (B, S), pspec=P("dp", None))
        model = GPTLMHeadModel(GPTConfig(**{**kw, **over}))
        loss = model(ids, ids)
    return g, model


@pytest.mark.parametrize("model", sorted(CONFIGS))
def test_shard_state_is_what_each_rank_holds(model):
    """``convert.shard_state`` gives each tp rank the shard its
    parameters hold after ``load_state`` of the global state (the fused
    qkv and SwiGLU weights block by block); ``gather_state`` inverts it."""
    kw = CONFIGS[model]
    state = _jax_state(kw)
    cfg = GPTConfig(**kw)
    shape = {"dp": 2, "tp": 2}
    shards = {}
    for dp in range(2):
        for tp in range(2):
            coords = {"dp": dp, "tp": tp}
            g, m = _build(kw, _Position(shape, coords))
            load_state(m, state)
            got = {_Params._norm(n): p.numpy()
                   for n, p in m.named_parameters()}
            want = shard_state(state, cfg, shape, coords)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            shards[tuple(coords.items())] = want
    back = gather_state(shards, cfg, shape)
    for k, v in state.items():
        np.testing.assert_array_equal(back[_Params._norm(k)], v)


def test_layouts_the_port_refuses_name_their_item():
    # 2 kv heads at tp 4 build (item 10b): the kv heads repeat over the
    # ranks, each holding its q head and the one kv head it reads
    pos = _Position({"tp": 4}, {"tp": 1})
    g, m = _build(CONFIGS["llama"], pos)
    qkv = dict(m.named_parameters())["transformer.h.0.attn.qkv.weight"]
    hd = BASE["hidden_size"] // BASE["num_heads"]
    assert tuple(qkv.shape) == (3 * hd, BASE["hidden_size"])
    with pytest.raises(ValueError, match="multiple of kv_heads"):
        _build(dict(CONFIGS["llama"], num_heads=12, hidden_size=96,
                    num_kv_heads=3), _Position({"tp": 4}, {"tp": 0}))
    with pytest.raises(NotImplementedError, match="item 10b"):
        _build(CONFIGS["gpt2"], _Position({"tp": 2}, {"tp": 0}),
               fused_lm_ce=True)
    with pytest.raises(ValueError, match="divisible by tp"):
        _build(dict(CONFIGS["gpt2"], vocab_size=63),
               _Position({"tp": 2}, {"tp": 0}))
