"""GPT/LLaMA training under context parallelism (``cp_axis``) in the port
against the JAX package's model on one device, on the CPU.

The tiny models of the JAX suite's CP test (vocab 64, hidden 32, 2
layers, 4 heads, seq 32, batch 4; the LLaMA with rotary, RMSNorm, SwiGLU
and 2 KV heads, the GPT-2 with learned positions and the fused qkv bias)
are built by the JAX model, and one JAX state dict is carried into the
port (``models.convert.load_state``).  Four gloo ranks
(tests/torch_ranks.py) train every layout 3 Adam steps (lr 1e-3) on one
global batch whose labels carry ``-100`` padding in uneven amounts per
row: the ring and Ulysses over ``{"cp": 2}`` (twice, on a spare axis
``r``), ``{"cp": 4}``, ``{"dp": 2, "cp": 2}`` (fed ``P("dp", None)`` and
``P("dp", "cp")``, with ZeRO-2 and with the global-norm clip) and
``{"cp": 2, "tp": 2}`` with sp, packed segment ids crossing the ranks'
block boundaries, and the fused LM-head cross entropy.  Each layout's
losses must be within 2e-5 of the JAX package's single-device run (the
same segments, the same clip) and its gathered final weights within
1e-5 (lr 1e-3 keeps Adam from turning the rounding noise of the k bias's
exactly-zero gradient into full steps, as in tests/test_torch_parallel.py).
"""
import numpy as np
import pytest

import hetu_tpu as jht
from hetu_tpu import optim as joptim
from hetu_tpu.models import GPTConfig as JaxGPTConfig
from hetu_tpu.models import GPTLMHeadModel as JaxGPTLMHeadModel
from hetu_tpu.models import llama_config as jax_llama_config

import hetu_tpu_torch as ht
from hetu_tpu_torch.models import GPTConfig, GPTLMHeadModel
from torch_ranks import run_ranks

LR, STEPS = 1e-3, 3
B, S = 4, 32
LOSS_TOL, WEIGHT_TOL = 2e-5, 1e-5
CLIP = 0.5
BASE = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=32, dropout=0.0, sp=False)
MODELS = {
    "llama": {"fn": "llama_config", "kw": dict(BASE, num_kv_heads=2)},
    "gpt2": {"fn": "GPTConfig", "kw": dict(BASE, position="learned",
                                           norm="layernorm",
                                           activation="gelu")},
}
R2 = {"r": 2}       # two replicas of a 2-rank layout over 4 ranks
RING = {"cp_axis": "cp", "cp_impl": "ring"}
ULY = {"cp_axis": "cp", "cp_impl": "ulysses"}
SP = {"sp": True}
# (name, mesh, config overrides, feed spec, packed segments, optimizer
# options); the JAX reference is the one-device run with the same
# segments and clip
LAYOUTS = {
    "llama": [
        ("cp2_ring", {**R2, "cp": 2}, RING, "dp", False, {}),
        ("cp2_ulysses", {**R2, "cp": 2}, ULY, "dp", False, {}),
        ("cp4_ring", {"cp": 4}, RING, "dp", False, {}),
        ("cp4_ulysses", {"cp": 4}, ULY, "dp", False, {}),
        ("dp2_cp2_ring", {"dp": 2, "cp": 2}, RING, "dp", False, {}),
        ("dp2_cp2_ring_fed_split", {"dp": 2, "cp": 2}, RING, "dp_cp", False,
         {}),
        ("dp2_cp2_ring_zero2", {"dp": 2, "cp": 2}, RING, "dp", False,
         {"zero": 2}),
        ("dp2_cp2_ring_clip", {"dp": 2, "cp": 2}, RING, "dp", False,
         {"max_grad_norm": CLIP}),
        ("cp2_tp2_sp_ring", {"cp": 2, "tp": 2}, {**RING, **SP}, "dp", False,
         {}),
        ("cp2_tp2_sp_ulysses", {"cp": 2, "tp": 2}, {**ULY, **SP}, "dp",
         False, {}),
        ("cp2_ring_packed", {**R2, "cp": 2}, RING, "dp", True, {}),
        ("cp4_ulysses_packed", {"cp": 4}, ULY, "dp", True, {}),
    ],
    "gpt2": [
        ("cp2_ring", {**R2, "cp": 2}, RING, "dp", False, {}),
        ("dp2_cp2_ulysses", {"dp": 2, "cp": 2}, ULY, "dp", False, {}),
        ("cp2_tp2_sp_ring", {"cp": 2, "tp": 2}, {**RING, **SP}, "dp", False,
         {}),
        ("dp2_cp2_ring_fused_ce", {"dp": 2, "cp": 2},
         {**RING, "fused_lm_ce": True}, "dp_cp", False, {}),
        ("cp2_ring_packed", {**R2, "cp": 2}, RING, "dp", True, {}),
    ],
}


def _batch():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 64, (B, S)).astype(np.int32)
    y = np.roll(x, -1, 1).copy()
    y[0, :5] = -100          # uneven valid counts across the blocks
    y[3, 20:] = -100
    # documents crossing the blocks' boundaries (8 tokens at cp 4)
    segs = np.zeros((B, S), np.int32)
    segs[:, 13:27] = 1
    segs[:, 27:] = 2
    segs[1, 5:] = 4
    return x, y, segs


def _jax_config(name, **kw):
    m = MODELS[name]
    fn = jax_llama_config if m["fn"] == "llama_config" else JaxGPTConfig
    return fn(**m["kw"], **kw)


def _jax_state(name):
    jht.set_seed(11)
    with jht.graph("eager", create_new=True):
        model = JaxGPTLMHeadModel(_jax_config(name))
        model.logits(np.zeros((1, 4), np.int32))
        return {k: np.asarray(v) for k, v in model.state_dict().items()}


def _jax_run(name, state, packed=False, clip=None):
    """The JAX package's one-device run: 3 Adam steps, losses and
    weights (normalised names)."""
    from hetu_tpu.models.generate import _Params as JParams
    x, y, segs = _batch()
    with jht.graph("define_and_run", create_new=True) as g:
        ids = jht.placeholder("int32", (B, S))
        labels = jht.placeholder("int32", (B, S))
        feeds = {ids: x, labels: y}
        seg_t = None
        if packed:
            seg_t = jht.placeholder("int32", (B, S))
            feeds[seg_t] = segs
        model = JaxGPTLMHeadModel(_jax_config(name))
        loss = model(ids, labels, segment_ids=seg_t)
        op = joptim.AdamOptimizer(lr=LR, max_grad_norm=clip).minimize(loss)
        model.load_state_dict(state)
    losses = [float(np.asarray(g.run(loss, [loss, op], feeds)[0]))
              for _ in range(STEPS)]
    weights = {JParams._norm(k): np.asarray(v, np.float32)
               for k, v in model.state_dict().items()}
    return losses, weights


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every layout of both models on 4 gloo ranks (one launch), and the
    JAX package's one-device runs they are held against."""
    tmp = tmp_path_factory.mktemp("cp_train")
    x, y, segs = _batch()
    np.savez(tmp / "batch.npz", x=x, y=y, segs=segs)
    out, jobs = {}, []
    for name in MODELS:
        state = _jax_state(name)
        np.savez(tmp / f"state_{name}.npz", **state)
        ref = {"plain": _jax_run(name, state),
               "packed": _jax_run(name, state, packed=True)}
        if name == "llama":
            ref["clip"] = _jax_run(name, state, clip=CLIP)
        out[name] = {"jax": ref}
        jobs.append(("cp_train", dict(
            state_path=str(tmp / f"state_{name}.npz"),
            batch_path=str(tmp / "batch.npz"), mk=MODELS[name],
            layouts=LAYOUTS[name], steps=STEPS, lr=LR)))
    res = run_ranks("many", 4, {"jobs": jobs}, tmp, timeout=240.0)
    for i, name in enumerate(MODELS):
        out[name]["port"] = [r[i] for r in res]
    return out


def _reference(runs, model, layout):
    _, _, _, _, packed, opt_kw = layout
    key = "packed" if packed else \
        "clip" if "max_grad_norm" in opt_kw else "plain"
    return runs[model]["jax"][key]


@pytest.mark.parametrize("model,layout", [
    (m, lay) for m in MODELS for lay in LAYOUTS[m]],
    ids=[f"{m}-{lay[0]}" for m in MODELS for lay in LAYOUTS[m]])
def test_cp_layout_matches_jax_single_device(runs, model, layout):
    name = layout[0]
    want_losses, want_weights = _reference(runs, model, layout)
    per_rank = [r[name] for r in runs[model]["port"]]
    got = per_rank[0]
    assert all(r["losses"] == got["losses"] for r in per_rank), \
        [r["losses"] for r in per_rank]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=0,
                               atol=LOSS_TOL)
    assert got["losses"][-1] < got["losses"][0]
    assert got["seq_axes"] == ["cp"]
    assert set(got["weights"]) == set(want_weights)
    for k, w in want_weights.items():
        np.testing.assert_allclose(got["weights"][k], w, rtol=0,
                                   atol=WEIGHT_TOL, err_msg=k)


def _hops(records, tag, kind="ppermute"):
    return sum(1 for r in records if r[0] == kind and r[5] == tag)


@pytest.mark.parametrize("model,name,cp,segs", [
    ("llama", "cp2_ring", 2, False), ("llama", "cp4_ring", 4, False),
    ("llama", "cp2_ring_packed", 2, True)])
def test_ring_hops_a_step(runs, model, name, cp, segs):
    """A step's ring hops over cp: each layer's forward moves k and v
    (and the kv ids with segments) ``cp - 1`` times, its backward the
    same again and dk, dv ``cp`` times; the gradients are summed over cp
    once a step (``grad_sync``), and the loss is reduced over cp."""
    rec = runs[model]["port"][0][name]["records"]
    layers = BASE["num_layers"]
    per = 3 if segs else 2
    assert _hops(rec, "ring/kv") == layers * 2 * (cp - 1) * per
    assert _hops(rec, "ring/dkv") == layers * cp * 2
    assert all(r[4] == "cp" for r in rec if r[5].startswith("ring/"))
    cp_sync = [r for r in rec if r[0] == "all_reduce" and r[4] == "cp"
               and r[5].startswith("grad_sync")]
    assert cp_sync and all(r[3] == "float32" for r in cp_sync)


def _cp_sync_bytes(runs, model, name):
    rec = runs[model]["port"][0][name]["records"]
    return sum(r[1] for r in rec if r[0] == "all_reduce" and r[4] == "cp"
               and r[5].startswith("grad_sync"))


def test_cp_grad_sum_acts_on_the_rank_piece(runs):
    """The sum over cp comes after the dp sync, on the piece the rank
    updates: under ZeRO-2 over dp 2 it carries half the bytes of the
    whole-gradient sum (every parameter of the tiny LLaMA chunks over
    dp), and without ZeRO the whole gradient, once."""
    whole = _cp_sync_bytes(runs, "llama", "dp2_cp2_ring")
    n_params = sum(w.size for w in
                   runs["llama"]["port"][0]["dp2_cp2_ring"]["weights"]
                   .values())
    assert whole == 4 * n_params
    assert 2 * _cp_sync_bytes(runs, "llama", "dp2_cp2_ring_zero2") == whole


def test_ulysses_moves_heads_not_kv(runs):
    """Ulysses' step: four all-to-alls a layer forward (q, k, v, out) and
    four backward, no ring hop."""
    rec = runs["llama"]["port"][0]["cp2_ulysses"]["records"]
    layers = BASE["num_layers"]
    assert sum(1 for r in rec if r[0] == "all_to_all"
               and r[5] == "ulysses") == layers * 4 * 2
    assert not any(r[5].startswith("ring/") for r in rec)


def test_cp_config_is_taken_and_bad_impl_refused():
    """``cp_axis`` is no longer refused; a graph without the cp axis keeps
    the JAX package's ValueError; an unknown ``cp_impl`` is refused by
    name; the pipeline model refuses ``cp_axis``."""
    from hetu_tpu_torch.models.gpt_pipeline import GPTPipelineModel
    cfg = GPTConfig(**MODELS["gpt2"]["kw"], cp_axis="cp")
    with ht.graph("define_and_run", create_new=True, device="cpu"):
        ids = ht.placeholder("int32", (B, S))
        with pytest.raises(ValueError, match="parallel_attention requires"):
            GPTLMHeadModel(cfg)(ids)
    with ht.graph("define_and_run", create_new=True, device="cpu"):
        with pytest.raises(ValueError, match="cp_impl"):
            GPTLMHeadModel(GPTConfig(**MODELS["gpt2"]["kw"], cp_axis="cp",
                                     cp_impl="tree"))
    with ht.graph("define_and_run", create_new=True, device="cpu"):
        with pytest.raises(NotImplementedError, match="cp_axis"):
            GPTPipelineModel(cfg, num_stages=1)
