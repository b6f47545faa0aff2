"""Serving cluster plane (port of ``hetu_tpu.serving.cluster``):
prefix-aware routing over N engine replicas, with disaggregated
prefill/decode and priced KV-page streaming.

    from hetu_tpu_torch.serving.cluster import EngineCluster

    # replicated: every replica serves prefill+decode; requests land on
    # the replica whose prefix cache holds their longest prefix
    cl = EngineCluster(state, cfg, num_replicas=2, num_pages=160,
                       page_size=64, max_batch=8, chunk_size=512)
    cl.add_request(prompt_ids, max_new_tokens=32)
    outputs = cl.run()                 # {req_id: generated tokens}
    print(cl.metrics_text())           # one exposition, replica-labeled
    cl.close()

    # disaggregated: prefill replicas stream KV pages to decode replicas
    # through a priced PageTransport
    cl = EngineCluster(state, cfg, num_replicas=2,
                       mode="disaggregated", num_prefill=1, ...)

The fault plane rides on top: seeded chaos injection
(``EngineCluster(chaos=...)``, ``hetu_tpu_torch.fault``), fencing
epochs, backoff retries with deadlines, destination-death re-staging,
load shedding and sticky quarantine with explicit
:meth:`EngineCluster.readmit_replica`; the SLO plane adds the class
backlog and the autoscaler (``serving.slo``).
"""
from .cluster import ClusterRequest, EngineCluster
from .replica import DECODE, PREFILL, UNIFIED, Replica
from .router import (Router, digest_match_pages,
                     match_pages_from_hashes)
from .transport import LocalPageTransport, PageTransport

__all__ = ["EngineCluster", "ClusterRequest", "Replica", "Router",
           "PageTransport", "LocalPageTransport", "digest_match_pages",
           "match_pages_from_hashes", "UNIFIED", "PREFILL", "DECODE"]
