"""The port's pipeline schedules (``hetu_tpu_torch.parallel.schedule``, a
copy of the JAX package's pure-Python module) against the JAX package's:
every generator, ``p2p_events``, ``max_in_flight`` and
``validate_schedule`` for S 1-4, M 1-8 and 2 chunks; and the SPMD
pipeline's collective sequence (``spmd_hop_schedule``) and its stacking
of per-layer weights (``stack_stage_params``)."""
import numpy as np
import pytest

from hetu_tpu.parallel import pipeline as jpipe
from hetu_tpu.parallel import schedule as jsched
from hetu_tpu_torch.parallel import pipeline as tpipe
from hetu_tpu_torch.parallel import schedule as tsched

CASES = [(S, M) for S in range(1, 5) for M in range(1, 9)]


def _plain(sched):
    return [[(t.kind, t.micro_batch) for t in stage] for stage in sched]


@pytest.mark.parametrize("gen", ["generate_gpipe_schedule",
                                 "generate_pipedream_flush_schedule",
                                 "generate_interleaved_1f1b_schedule"])
def test_schedules_equal_jax(gen):
    """Each generator's task lists, their P2P projection, in-flight
    peaks and validation equal the JAX package's."""
    for S, M in CASES:
        args = (S, M, 2) if gen.endswith("interleaved_1f1b_schedule") \
            else (S, M)
        want = getattr(jsched, gen)(*args)
        got = getattr(tsched, gen)(*args)
        assert _plain(got) == _plain(want), (gen, S, M)
        assert tsched.p2p_events(got) == jsched.p2p_events(want)
        assert [tsched.max_in_flight(t) for t in got] == \
            [jsched.max_in_flight(t) for t in want]
        tsched.validate_schedule(got, M)
        if gen == "generate_pipedream_flush_schedule":
            assert [tsched.max_in_flight(t) for t in got] == \
                [min(M, S - s) for s in range(S)]


def test_inference_and_invalid_schedules():
    for S, M in CASES:
        assert _plain(tsched.generate_pipedream_flush_schedule(
            S, M, inference=True)) == _plain(
            jsched.generate_pipedream_flush_schedule(S, M, inference=True))
    bad = [[tsched.Task("B", 0), tsched.Task("F", 0)]]
    with pytest.raises(AssertionError):
        tsched.validate_schedule(bad, 1)
    with pytest.raises(AssertionError):
        tsched.validate_schedule([[tsched.Task("F", 0)]], 1)
    assert repr(tsched.Task("F", 3)) == "F3"


@pytest.mark.parametrize("M,S", [(1, 2), (4, 2), (8, 4)])
def test_spmd_hop_schedule_equals_jax(M, S):
    """With the aux scalar the sequence is the JAX package's less the
    last tick's hop, which no stage reads and the port leaves out;
    without it (the port's dense pipeline, the default) one collect."""
    T = M + S - 1
    want = jpipe.spmd_hop_schedule(M, S)
    assert want[:T] == [("ppermute", "pipeline/hop")] * T
    assert tpipe.spmd_hop_schedule(M, S, with_aux=True) == \
        want[:T - 1] + want[T:]
    assert tpipe.spmd_hop_schedule(M, S) == want[:T - 1] + want[T:-1]


@pytest.mark.parametrize("L,S", [(4, 2), (6, 3), (2, 1)])
def test_stack_stage_params_equals_jax(L, S):
    """``stack_stage_params`` stacks per-layer dicts into ``[S, L/S,
    ...]`` leaves as the JAX package's does, and refuses layers the
    stages do not divide."""
    import torch
    rng = np.random.RandomState(L * 10 + S)
    layers = [{"w": rng.randn(3, 2).astype(np.float32),
               "b": rng.randn(3).astype(np.float32)} for _ in range(L)]
    got = tpipe.stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in p.items()} for p in layers],
        S)
    want = jpipe.stack_stage_params(layers, S)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == (S, L // S) + layers[0][k].shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="not divisible"):
        tpipe.stack_stage_params(layers, L + 1)
