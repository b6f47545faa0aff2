"""Serving subsystem of the port: paged KV-cache pool + continuous-
batching engine driving one unified ragged prefill+decode step.

    from hetu_tpu_torch.models.convert import random_state
    from hetu_tpu_torch.serving import Engine

    eng = Engine(state, cfg, num_pages=128, page_size=64, max_batch=8,
                 chunk_size=64, prefill_rows=1)          # device="cuda"
    req = eng.add_request(prompt_ids, max_new_tokens=64,
                          temperature=0.8, top_p=0.95, seed=7)
    outputs = eng.run()            # {req_id: generated token list}

The cluster plane and speculative decoding come with later slices.
"""
from .engine import Engine
from .kv_pool import TRASH_PAGE, PagedKVPool
from .prefix_cache import CacheEntry, PrefixCache
from .request import FINISHED, RUNNING, WAITING, Request, RequestQueue
from .scheduler import Scheduler

__all__ = ["Engine", "PagedKVPool", "TRASH_PAGE", "PrefixCache",
           "CacheEntry", "Request", "RequestQueue", "Scheduler",
           "WAITING", "RUNNING", "FINISHED"]
