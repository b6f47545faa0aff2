"""Cluster coordination (port of ``hetu_tpu.rpc``, in part): the
rendezvous / KV / barrier / heartbeat service.  The launcher and the
multi-host bootstrap come with the multi-GPU mesh (ROADMAP queue 1
item 10)."""
from .coordinator import CoordinatorClient, CoordinatorServer

__all__ = ["CoordinatorServer", "CoordinatorClient"]
