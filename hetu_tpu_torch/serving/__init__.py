"""Serving subsystem of the port: paged KV-cache pool + continuous-
batching engine driving one unified ragged prefill+decode step.

    from hetu_tpu_torch.models.convert import random_state
    from hetu_tpu_torch.serving import Engine

    eng = Engine(state, cfg, num_pages=128, page_size=64, max_batch=8,
                 chunk_size=64, prefill_rows=1)          # device="cuda"
    req = eng.add_request(prompt_ids, max_new_tokens=64,
                          temperature=0.8, top_p=0.95, seed=7)
    outputs = eng.run()            # {req_id: generated token list}

Speculative decoding with a truncated self-draft::

    from hetu_tpu_torch.models import draft_state_from
    from hetu_tpu_torch.serving import SpecConfig

    eng = Engine(state, cfg,
                 spec=SpecConfig(*draft_state_from(state, cfg, 2), k=4))

The draft proposes ``k`` greedy tokens a decode-ready request, the step
verifies them as ragged verify rows; temperature-0 output equals the
non-speculative engine's.

N replicas behind one router, replicated or disaggregated (prefill
replicas streaming KV pages to decode replicas), with the fault and SLO
planes::

    from hetu_tpu_torch.serving import EngineCluster

    cl = EngineCluster(state, cfg, num_replicas=2, policy="prefix")
"""
from .engine import Engine
from .kv_pool import TRASH_PAGE, PagedKVPool
from .prefix_cache import CacheEntry, PrefixCache
from .request import FINISHED, RUNNING, WAITING, Request, RequestQueue
from .scheduler import Scheduler
from .spec import SpecConfig, SpecDecoder
from .cluster import EngineCluster

__all__ = ["Engine", "PagedKVPool", "TRASH_PAGE", "PrefixCache",
           "CacheEntry", "Request", "RequestQueue", "Scheduler",
           "WAITING", "RUNNING", "FINISHED", "SpecConfig", "SpecDecoder",
           "EngineCluster"]
