"""The port's sharding spec (``hetu_tpu_torch.parallel.dstates``), its
mesh helpers and its JSON layout IR against the JAX package's, on the
cases of tests/test_dstates.py: the same predicates, deduced collectives,
device mappings, pspec lowerings and collective predictions.  Pure
Python; no process group."""
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from hetu_tpu.nn.parallel import config2ds as jax_config2ds
from hetu_tpu.parallel import dstates as jds
from hetu_tpu.parallel.mesh import ds_from_partition_spec as jax_ds_from_spec
from hetu_tpu.utils import ds_config as jcfg
from hetu_tpu_torch.nn.parallel import config2ds
from hetu_tpu_torch.parallel import P, dstates as pds
from hetu_tpu_torch.parallel.mesh import (ds_from_partition_spec,
                                          ds_to_mesh_and_spec, local_shape,
                                          shard_pieces, take_shard, unblock)
from hetu_tpu_torch.utils import ds_config as pcfg

D, PA = -1, -2

# (device_num, states, order) pairs: src -> dst, from tests/test_dstates.py
PAIRS = [
    ((4, {PA: 4}, None), (4, {D: 4}, None)),
    ((8, {0: 2, PA: 4}, [0, -2]), (8, {0: 2, D: 4}, [0, -1])),
    ((4, {1: 4}, None), (4, {D: 4}, None)),
    ((4, {0: 2, 1: 2}, [0, 1]), (4, {0: 2, D: 2}, [0, -1])),
    ((4, {PA: 4}, None), (4, {0: 4}, None)),
    ((4, {D: 4}, None), (4, {0: 4}, None)),
    ((4, {0: 4}, None), (4, {0: 4}, None)),
    ((4, {0: 4}, None), (4, {1: 4}, None)),
    ((4, {0: 4}, None), (4, {D: 4}, None)),
]
PREDICATES = ("check_allreduce", "check_allgather", "check_reducescatter",
              "check_scatter")


def _pair(mod, spec):
    n, states, order = spec
    return mod.DistributedStates(n, states, order)


@pytest.mark.parametrize("src,dst", PAIRS)
def test_predicates_and_deduced_kind_equal_jax(src, dst):
    ps, pd = _pair(pds, src), _pair(pds, dst)
    js, jd = _pair(jds, src), _pair(jds, dst)
    for name in PREDICATES:
        assert getattr(ps, name)(pd) == getattr(js, name)(jd), name
    assert pds.deduce_comm_kind(ps, pd) == jds.deduce_comm_kind(js, jd)


def test_device_mapping_equals_jax():
    for mod in (pds, jds):
        ds = mod.DistributedStates(8, {0: 2, 1: 4})
        assert ds.map_device_to_state_index(5)[0] == 1
    p = pds.DistributedStates(8, {0: 2, 1: 4})
    j = jds.DistributedStates(8, {0: 2, 1: 4})
    for dev in range(8):
        assert p.map_device_to_state_index(dev) == \
            j.map_device_to_state_index(dev)
        assert p.local_slice((8, 16), dev) == j.local_slice((8, 16), dev)
        for dim in (0, 1):
            assert p.get_group_indices_by_dim(dim, dev) == \
                j.get_group_indices_by_dim(dim, dev)
    assert p.get_loop_sizes() == j.get_loop_sizes() == [4, 1]
    pd = pds.DistributedStates(8, {0: 2, D: 4}, order=[0, -1])
    jd = jds.DistributedStates(8, {0: 2, D: 4}, order=[0, -1])
    assert [pd.get_dup_group_index(i) for i in range(8)] == \
        [jd.get_dup_group_index(i) for i in range(8)]
    with pytest.raises(ValueError):
        pds.DistributedStates(8, {0: 2, 1: 2})
    assert pds.DistributedStates(4, {0: 2, D: 2}) == \
        pds.DistributedStates(4, {0: 2, -1: 2})


SPECS = [("dp", "tp"), (("dp", "tp"),), ("dp", None), (None, "tp"),
         (None, None), ("tp",)]


@pytest.mark.parametrize("spec", SPECS)
def test_pspec_lowerings_equal_jax(spec):
    axes = {"dp": 2, "tp": 4}
    ndim = max(len(spec), 2)
    shape = (8, 16)[:ndim]
    pd = pds.pspec_to_ds(P(*spec), ndim, axes)
    jd = jds.pspec_to_ds(JP(*spec), ndim, axes)
    assert (pd.states, pd.order) == (jd.states, jd.order)
    assert pds.pspec_shard_divisor(P(*spec), axes) == \
        jds.pspec_shard_divisor(JP(*spec), axes)
    for other in SPECS:
        assert pds.deduce_pspec_transition(
            P(*spec), shape, P(*other), shape, axes) == \
            jds.deduce_pspec_transition(JP(*spec), shape, JP(*other), shape,
                                        axes)
    for partial in ((), ("dp",)):
        if partial and "dp" in str(spec):
            continue
        p = ds_from_partition_spec(axes, P(*spec), partial_axes=partial)
        j = jax_ds_from_spec(_FakeMesh(axes), JP(*spec),
                             partial_axes=partial)
        assert (p.states, p.order) == (j.states, j.order)


class _FakeMesh:
    """The two attributes ``ds_from_partition_spec`` reads of a jax Mesh."""

    def __init__(self, axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


def test_ds_to_mesh_and_spec_orders_axes_as_the_ds():
    ds = pds.DistributedStates(8, {0: 2, 1: 4})
    axes, spec = ds_to_mesh_and_spec(ds)
    assert axes == {"_s0": 2, "_s1": 4} and spec == P("_s0", "_s1")
    axes, spec = ds_to_mesh_and_spec(
        pds.DistributedStates(8, {0: 2, D: 4}, order=[0, -1]))
    assert axes == {"_s0": 2, "_dup": 4} and spec == P("_s0")
    # round trip: the DS of the spec over those axes is the DS
    back = ds_from_partition_spec(axes, spec)
    assert (back.get_dim(0), back.get_dim(D), back.order) == (2, 4, [0, -1])


@pytest.mark.parametrize("transport", ["fp32", "bf16", "int8"])
def test_collective_predictions_equal_jax(transport):
    entries = [(i, s, dt) for i, (s, dt) in enumerate(
        [((64, 32), "float32"), ((32,), "float32"), ((7, 5), "bfloat16"),
         ((300,), "float32"), ((128, 8), "bfloat16")])]
    for n in (2, 4):
        for mb in (4.0, 0.005):
            assert pds.predict_grad_comm_collectives(
                entries, n, mb, transport) == \
                jds.predict_grad_comm_collectives(entries, n, mb, transport)
            for zero in (2, 3):
                assert pds.predict_flat_update_collectives(
                    entries, n, mb, transport, zero=zero) == \
                    jds.predict_flat_update_collectives(
                        entries, n, mb, transport, zero=zero)
            assert pds.predict_update_step_collectives(
                entries, n, transport, mb, flat=True, clip=True) == \
                jds.predict_update_step_collectives(
                    entries, n, transport, mb, flat=True, clip=True)


def test_union_and_hierarchy():
    u = pds.DistributedStatesUnion(
        [pds.DistributedStates(4, {0: 4}),
         pds.DistributedStates(4, {0: 2, -1: 2})], hetero_dim=0)
    assert u.is_hetero() and u.size() == 2 and u.get(0).get_dim(0) == 4
    h = pds.DistributedStatesHierarchy([u])
    assert h.size() == 1 and h.get(0) is u


def test_ds_config_and_config2ds_equal_jax():
    for dp, tp, pp in ((2, 2, 1), (1, 4, 2), (2, 1, 2)):
        pc = pcfg.generate_gpt_3d_config(4, dp, tp, pp)
        jc = jcfg.generate_gpt_3d_config(4, dp, tp, pp)
        assert pc == jc
        assert pcfg.parse_layout(pc) == jcfg.parse_layout(jc)
        assert list(pcfg.iter_block_entries(pc)) == \
            list(jcfg.iter_block_entries(jc))
        for _, _, entry in pcfg.iter_block_entries(pc):
            pu, pg = config2ds(entry)
            ju, jg = jax_config2ds(entry)
            assert pg == jg
            assert [(d.states, d.order, d.zero) for d in pu.ds_list] == \
                [(d.states, d.order, d.zero) for d in ju.ds_list]
    stages = [{"dp": 2, "tp": 1, "devices": [0, 1], "layers": [0, 2]},
              {"dp": 1, "tp": 2, "devices": [2, 3], "layers": [2, 4]}]
    ph = pcfg.generate_gpt_hetero_3d_config(4, stages)
    assert ph == jcfg.generate_gpt_hetero_3d_config(4, stages)
    assert pcfg.parse_hetero_layout(ph) == jcfg.parse_hetero_layout(ph)


class _Coords:
    """A stand-in mesh at one position (the shard helpers read
    ``axis_names``, ``shape`` and ``coords``)."""

    def __init__(self, shape, coords):
        self.axis_names, self.shape, self.coords = tuple(shape), shape, coords


def test_block_shards_put_back_together():
    """A fused [q | k | v] weight split block by block over tp 2: each
    rank holds its part of every block, and the gathered shards
    ``unblock`` into the global value."""
    g = np.arange(24 * 3, dtype=np.float32).reshape(24, 3)
    blocks = (8, 8, 8)
    shards = [take_shard(g, P("tp", None), _Coords({"tp": 2}, {"tp": i}),
                         blocks) for i in range(2)]
    assert shards[0].shape == (12, 3)
    np.testing.assert_array_equal(shards[0][:4], g[:4])       # q, rank 0
    np.testing.assert_array_equal(shards[0][4:8], g[8:12])    # k, rank 0
    np.testing.assert_array_equal(shards[1][:4], g[4:8])      # q, rank 1
    got = unblock(torch.from_numpy(np.concatenate(shards)), 2, blocks)
    np.testing.assert_array_equal(got.numpy(), g)
    mesh = _Coords({"dp": 2, "tp": 2}, {"dp": 1, "tp": 0})
    assert local_shape((8, 6), P("dp", "tp"), mesh) == (4, 3)
    (gs, _), = shard_pieces((8, 6), P("dp", "tp"), mesh)
    assert gs == (slice(4, 8), slice(0, 3))
