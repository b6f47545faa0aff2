"""The port's MPMD pipeline runtime (``parallel.pipeline_mpmd``) and
``models.gpt_mpmd.MPMDGPT`` against the JAX package's, on the CPU at a
tiny size, with JAX's ``meshes=None`` (every stage on one device).

The two ``MPMDGPT``s draw their weights from one ``RandomState(seed)``
in one order, so they start from the same numbers without conversion.
The cases are the JAX suite's (``tests/test_pipeline_mpmd.py``):
heterogeneous stages against one stage, 1F1B's stash against GPipe's,
two pipelines with unequal micro-batch counts, interleaved virtual
stages, tied embeddings, an unknown schedule, the dtype of the gradient
accumulation; plus the executed ``p2p_log`` against the schedule's
``p2p_events`` and the port's refusals by ROADMAP item.
"""
import numpy as np
import pytest
import torch

from hetu_tpu.models import gpt as jgpt
from hetu_tpu.models.gpt_mpmd import MPMDGPT as JMPMDGPT
from hetu_tpu.parallel.pipeline_mpmd import MPMDAdam as JMPMDAdam
from hetu_tpu_torch.models import gpt as tgpt
from hetu_tpu_torch.models.gpt_mpmd import MPMDGPT
from hetu_tpu_torch.parallel.pipeline_mpmd import (MPMDAdam, _accum_grads,
                                                   _scale_grads)
from hetu_tpu_torch.parallel.schedule import (
    generate_gpipe_schedule, generate_pipedream_flush_schedule, p2p_events)


def _kw(**kw):
    base = dict(vocab_size=96, hidden_size=48, num_layers=8, num_heads=4,
                max_seq_len=16, dtype="float32")
    base.update(kw)
    return base


def _data(batch, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 96, (batch, 16)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _pair(stage_layers, seed, fn="llama_config", jax_layers=None, **kw):
    """The JAX and the port model of one config and seed."""
    j = JMPMDGPT(getattr(jgpt, fn)(**_kw(**kw)),
                 stage_layers=jax_layers or stage_layers, seed=seed)
    t = MPMDGPT(getattr(tgpt, fn)(**_kw(**kw)), stage_layers=stage_layers,
                seed=seed, device="cpu")
    return j, t


def _train(model, opt_cls, ids, labels, mbs, steps):
    opt = opt_cls(model.runtime, lr=1e-2)
    losses, stats = [], None
    for _ in range(steps):
        loss, grads, stats = model.train_step(
            model.split_micro_batches(ids, labels, mbs))
        opt.apply(grads)
        losses.append(float(loss))
    return losses, stats


@pytest.mark.parametrize("layers,schedule,chunks", [
    ([[1, 1, 3, 3]], "1f1b", 1), ([[8]], "1f1b", 1),
    ([[2, 2, 2, 2]], "interleaved", 2)])
def test_layouts_match_jax_single_stage(layers, schedule, chunks):
    """Heterogeneous stages, one stage, and 2 physical stages x 2 chunks
    train as JAX's one stage does (the JAX suite's rtol 2e-4)."""
    ids, labels = _data(8)
    j = JMPMDGPT(jgpt.llama_config(**_kw()), stage_layers=[[8]], seed=3)
    t = MPMDGPT(tgpt.llama_config(**_kw()), stage_layers=layers,
                schedule=schedule, num_chunks=chunks, seed=3, device="cpu")
    want, _ = _train(j, JMPMDAdam, ids, labels, [4], 3)
    got, stats = _train(t, MPMDAdam, ids, labels, [4], 3)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert want[-1] < want[0]
    assert stats.num_tasks == 2 * 4 * sum(len(s) for s in layers)


def test_1f1b_stash_below_gpipe_at_m8():
    ids, labels = _data(8)
    res = {}
    for sched in ("1f1b", "gpipe"):
        t = MPMDGPT(tgpt.llama_config(**_kw(num_layers=4)),
                    stage_layers=[[1, 1, 1, 1]], schedule=sched, seed=0,
                    device="cpu")
        loss, _, stats = t.train_step(t.split_micro_batches(ids, labels,
                                                            [8]))
        res[sched] = (loss, stats)
    j = JMPMDGPT(jgpt.llama_config(**_kw(num_layers=4)),
                 stage_layers=[[1, 1, 1, 1]], seed=0)
    want, _, _ = j.train_step(j.split_micro_batches(ids, labels, [8]))
    np.testing.assert_allclose(res["1f1b"][0], res["gpipe"][0], rtol=1e-5)
    np.testing.assert_allclose(res["1f1b"][0], float(want), rtol=2e-5)
    s1, sg = res["1f1b"][1], res["gpipe"][1]
    assert s1.stash_peak == [4, 3, 2, 0] and max(sg.stash_peak) == 8
    assert max(s1.stash_peak_bytes) < max(sg.stash_peak_bytes)
    assert s1.controller_seconds > 0 and s1.sync_seconds >= 0


def test_unequal_micro_batches_across_pipelines():
    """Pipelines [[2, 2], [1, 3]] with micro-batch counts [3, 1] against
    one pipeline of one stage: the ``wte`` and ``layer3.qkv`` gradients
    (JAX's and the port's one-stage run)."""
    ids, labels = _data(8)
    j = JMPMDGPT(jgpt.llama_config(**_kw(num_layers=4)), stage_layers=[[4]],
                 seed=1)
    _, gj, _ = j.train_step(j.split_micro_batches(ids, labels, [4]))
    t = MPMDGPT(tgpt.llama_config(**_kw(num_layers=4)),
                stage_layers=[[2, 2], [1, 3]], seed=1, device="cpu")
    _, gt, _ = t.train_step(t.split_micro_batches(ids, labels, [3, 1]))
    np.testing.assert_allclose(gt[0][0]["wte"].numpy(),
                               np.asarray(gj[0][0]["wte"]), rtol=5e-4,
                               atol=1e-6)
    np.testing.assert_allclose(gt[1][1]["layer3"]["qkv"].numpy(),
                               np.asarray(gj[0][0]["layer3"]["qkv"]),
                               rtol=5e-4, atol=1e-6)
    # the pipelines' copies of a layer get the summed gradient
    np.testing.assert_array_equal(gt[0][1]["layer3"]["qkv"].numpy(),
                                  gt[1][1]["layer3"]["qkv"].numpy())


def test_tied_embeddings_match_single_stage():
    """The tied ``wte`` of the first and last stage: gradients summed by
    key, pp 2 equal to pp 1 and to JAX, and training keeps the copies
    equal."""
    ids, labels = _data(4)
    j, one = _pair([[2]], 5, num_layers=2, tie_embeddings=True)
    two = MPMDGPT(tgpt.llama_config(**_kw(num_layers=2,
                                          tie_embeddings=True)),
                  stage_layers=[[1, 1]], seed=5, device="cpu")
    lj, gj, _ = j.train_step(j.split_micro_batches(ids, labels, [2]))
    l1, g1, _ = one.train_step(one.split_micro_batches(ids, labels, [2]))
    l2, g2, _ = two.train_step(two.split_micro_batches(ids, labels, [2]))
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    np.testing.assert_allclose(float(l1), float(lj), rtol=2e-5)
    np.testing.assert_allclose(g1[0][0]["wte"].numpy(),
                               g2[0][0]["wte"].numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(g2[0][0]["wte"].numpy(),
                               g2[0][1]["wte_head"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(g1[0][0]["wte"].numpy(),
                               np.asarray(gj[0][0]["wte"]), rtol=1e-4,
                               atol=1e-6)
    _train(two, MPMDAdam, ids, labels, [2], 3)
    np.testing.assert_allclose(
        two.runtime.pipes[0][0].params["wte"].numpy(),
        two.runtime.pipes[0][1].params["wte_head"].numpy(), rtol=1e-6)


def _plain_names(state, cfg):
    """An ``MPMDGPT.gather_state`` snapshot under ``GPTLMHeadModel``'s
    normalised names."""
    names = {"ln1": "ln_1", "ln2": "ln_2", "qkv": "attn.qkv",
             "attn_out": "attn.out", "mlp_up": "mlp.up",
             "mlp_down": "mlp.down"}
    out = {"wte.weight": state["wte"], "ln_f.weight": state["ln_f"]["g"],
           "ln_f.bias": state["ln_f"].get("b"), "wpe": state.get("wpe"),
           "lm_head.weight": state.get("head")}
    for i in range(cfg.num_layers):
        for k, v in state[f"layer{i}"].items():
            if isinstance(v, dict):
                out[f"h{i}.{names[k]}.weight"] = v["g"]
                out[f"h{i}.{names[k]}.bias"] = v.get("b")
            elif k.endswith("_b"):
                out[f"h{i}.{names[k[:-2]]}.bias"] = v
            else:
                out[f"h{i}.{names[k]}.weight"] = v
    return {k: v for k, v in out.items() if v is not None}


@pytest.mark.parametrize("layers,mbs,tie", [
    ([[2]], [4], False), ([[1, 1]], [4], True),
    ([[1, 1], [1, 1]], [3, 1], True)])
def test_layouts_train_as_the_plain_model(layers, mbs, tie):
    """GPT-2 blocks trained 3 Adam steps through the MPMD runtime (one
    stage, two, and two pipelines with the tied ``wte``) equal the port's
    plain ``GPTLMHeadModel`` loaded with the same weights: losses within
    1e-5, every tensor's update within 1 %, and every copy of a shared
    parameter stepped once (the copies are separate tensors)."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.models.convert import load_state
    from hetu_tpu_torch.models.generate import _Params
    cfg = tgpt.GPTConfig(**_kw(num_layers=2, tie_embeddings=tie))
    ids, labels = _data(4)
    model = MPMDGPT(cfg, stage_layers=layers, seed=2, device="cpu")
    init = _plain_names(model.gather_state(), cfg)
    got, _ = _train(model, MPMDAdam, ids, labels, mbs, 3)
    final = _plain_names(model.gather_state(), cfg)
    with ht.graph("define_and_run", create_new=True, seed=0,
                  device="cpu") as g:
        x = ht.placeholder("int32", ids.shape)
        y = ht.placeholder("int32", ids.shape)
        plain = tgpt.GPTLMHeadModel(cfg)
        loss = plain(x, y)
        op = ht.optim.AdamOptimizer(lr=1e-2).minimize(loss)
    g.run([], run_level="alloc")
    load_state(plain, init)
    want = [float(g.run(loss, [loss, op], {x: ids, y: labels},
                        num_micro_batches=sum(mbs))[0]) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    after = {_Params._norm(n): g.global_value(p).numpy()
             for n, p in plain.named_parameters()}
    assert set(after) == set(final)
    for k, w in after.items():
        moved = np.linalg.norm(w - init[k])
        assert moved > 0, k
        assert np.linalg.norm(final[k] - w) <= 1e-2 * moved, k


def test_gpt2_architecture_with_dropout_trains():
    """GPT-2 blocks (gelu and biases, layernorm, learned positions), GQA
    and dropout through two stages; the recompute draws the forward's
    masks, so the gradients are those of the forward that ran."""
    cfg = tgpt.GPTConfig(**_kw(num_layers=4, num_kv_heads=2, dropout=0.1))
    ids, labels = _data(4)
    model = MPMDGPT(cfg, stage_layers=[[2, 2]], seed=0, device="cpu")
    opt = MPMDAdam(model.runtime, lr=1e-2)
    losses = []
    for step in range(6):
        loss, grads, _ = model.train_step(
            model.split_micro_batches(ids, labels, [2]), seed=step)
        opt.apply(grads)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    a, _, _ = model.train_step(model.split_micro_batches(ids, labels, [2]),
                               seed=7)
    b, _, _ = model.train_step(model.split_micro_batches(ids, labels, [2]),
                               seed=7)
    assert a == b


@pytest.mark.parametrize("schedule,gen", [
    ("1f1b", generate_pipedream_flush_schedule),
    ("gpipe", generate_gpipe_schedule)])
def test_p2p_log_equals_the_schedules_events(schedule, gen):
    ids, labels = _data(8)
    t = MPMDGPT(tgpt.llama_config(**_kw(num_layers=4)),
                stage_layers=[[1, 1, 1, 1]], schedule=schedule, seed=0,
                device="cpu")
    t.train_step(t.split_micro_batches(ids, labels, [4]))
    by_stage = [[] for _ in range(4)]
    for kind, fb, p, s, m, peer in t.runtime.p2p_log:
        by_stage[s].append((kind, fb, m, peer))
    assert by_stage == p2p_events(gen(4, 4))


def test_state_round_trip():
    ids, labels = _data(8)
    a = MPMDGPT(tgpt.llama_config(**_kw(num_layers=4)),
                stage_layers=[[1, 3]], seed=0, device="cpu")
    _train(a, MPMDAdam, ids, labels, [2], 1)
    b = MPMDGPT(tgpt.llama_config(**_kw(num_layers=4)),
                stage_layers=[[2, 2]], seed=9, device="cpu")
    b.load_state(a.gather_state())
    la, _, _ = a.train_step(a.split_micro_batches(ids, labels, [2]))
    lb, _, _ = b.train_step(b.split_micro_batches(ids, labels, [2]))
    np.testing.assert_allclose(la, lb, rtol=1e-6)


def test_unknown_schedule_rejected():
    with pytest.raises(ValueError, match="unknown schedule"):
        MPMDGPT(tgpt.llama_config(**_kw()), stage_layers=[[8]],
                schedule="interleave", device="cpu")


def test_bf16_grad_scale_accum_keeps_dtype():
    dp = {"w": torch.ones((4, 4), dtype=torch.bfloat16),
          "b": torch.ones((4,), dtype=torch.float32)}
    scaled = _scale_grads(dp, 0.25)
    assert scaled["w"].dtype == torch.bfloat16
    assert scaled["b"].dtype == torch.float32
    acc = _accum_grads(scaled, dp, 0.25)
    assert acc["w"].dtype == torch.bfloat16
    assert acc["b"].dtype == torch.float32
    np.testing.assert_allclose(acc["b"].numpy(), 0.5)


class _Sub:
    """A submesh of the JAX package's kind: named axes and sizes."""

    def __init__(self, shape):
        self.shape, self.device = shape, torch.device("cpu")


@pytest.mark.parametrize("call,match", [
    (lambda cfg: MPMDGPT(cfg, stage_layers=[[4, 4]], device="cpu",
                         meshes=[[_Sub({"dp": 1, "tp": 2}), None]]),
     "item 11b"),
    (lambda cfg: MPMDGPT(cfg, stage_layers=[[8]], device="cpu"
                         ).register_analysis("x", 2, 16), "item 18"),
    (lambda cfg: MPMDGPT(tgpt.llama_config(**_kw(num_experts=4)),
                         stage_layers=[[8]], device="cpu"),
     "MPMD path has no MoE blocks")])
def test_refusals_name_their_item(call, match):
    with pytest.raises(NotImplementedError, match=match):
        call(tgpt.llama_config(**_kw()))


def test_a_size_one_submesh_is_its_device():
    m = MPMDGPT(tgpt.llama_config(**_kw()), stage_layers=[[4, 4]],
                device="cpu", meshes=[[_Sub({"dp": 1, "tp": 1}), None]])
    assert [st.device.type for st in m.runtime.pipes[0]] == ["cpu", "cpu"]
