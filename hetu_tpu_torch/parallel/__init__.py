"""The multi-GPU mesh (port of ``hetu_tpu.parallel``, its core): the
sharding spec (``dstates``), process-group meshes (``mesh``), the
collectives with their accounting (``comm``), and the pipelines: the
schedules (``schedule``), the SPMD pipeline over a ``pp`` axis
(``pipeline``) and the MPMD runtime (``pipeline_mpmd``), and context
parallelism: ring attention (``ring_attention``) and Ulysses
(``ulysses``), and hot switching between layouts (``switch``).  As in the
JAX package, the function ``ring_attention`` is exported under its module's
name (``importlib.import_module`` reaches the module)."""
from . import comm, dstates
from .dstates import (DUPLICATE, NULL_HETERO_DIM, PARTIAL,
                      DistributedStates, DistributedStatesHierarchy,
                      DistributedStatesUnion, SplitPattern, deduce_comm_kind,
                      predict_flat_update_collectives,
                      predict_grad_comm_collectives,
                      predict_update_step_collectives)
from .mesh import (AXIS_CP, AXIS_DP, AXIS_EP, AXIS_PP, AXIS_TP, Mesh, P,
                   PartitionSpec, choose_backend, create_mesh,
                   ds_from_partition_spec, ds_to_mesh_and_spec,
                   init_process_group, mesh_axis_size, single_device_mesh)
from .ring_attention import ring_attention, ring_attention_sharded
from .switch import (SwitchExecGraph, SwitchMode, SwitchPlan, SwitchProfile,
                     switch_state, symbolic_repack_transfers)

__all__ = [
    "DUPLICATE", "PARTIAL", "NULL_HETERO_DIM",
    "DistributedStates", "DistributedStatesUnion",
    "DistributedStatesHierarchy", "SplitPattern", "deduce_comm_kind",
    "dstates", "comm", "predict_grad_comm_collectives",
    "predict_flat_update_collectives", "predict_update_step_collectives",
    "AXIS_DP", "AXIS_CP", "AXIS_TP", "AXIS_PP", "AXIS_EP",
    "Mesh", "P", "PartitionSpec", "choose_backend", "create_mesh",
    "init_process_group", "single_device_mesh", "mesh_axis_size",
    "ds_to_mesh_and_spec", "ds_from_partition_spec",
    "ring_attention", "ring_attention_sharded",
    "SwitchExecGraph", "SwitchMode", "SwitchPlan", "SwitchProfile",
    "switch_state", "symbolic_repack_transfers",
]
