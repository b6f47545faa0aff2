"""SLO-driven traffic plane (port of ``hetu_tpu.serving.slo``): priority
classes over the scheduler and router, a replica autoscaler riding the
cluster's register/readmit/drain lifecycle, and a host-RAM tier for
cold prefix-cache pages."""
from .autoscaler import Autoscaler
from .backlog import ClassBacklog
from .classes import CLASS_RANK, DEFAULT_TARGETS, SLO_CLASSES, class_rank
from .host_tier import HostTier

__all__ = ["Autoscaler", "ClassBacklog", "CLASS_RANK",
           "DEFAULT_TARGETS", "SLO_CLASSES", "class_rank", "HostTier"]
