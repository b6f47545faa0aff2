"""Cluster coordination (port of ``hetu_tpu.rpc``): the rendezvous / KV /
barrier / heartbeat service, the launcher, and ``distributed_init``, the
bootstrap of a multi-process mesh."""
from .coordinator import (CoordinatorClient, CoordinatorServer,
                          distributed_init)
from .launcher import HostSpec, Launcher, load_hostfile, worker_client

__all__ = ["CoordinatorServer", "CoordinatorClient", "Launcher", "HostSpec",
           "distributed_init", "load_hostfile", "worker_client"]
