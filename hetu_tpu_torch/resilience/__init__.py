"""Resilience plane (counterpart of ``hetu_tpu.resilience``): silent-failure
detection and durable checkpoints.

* :mod:`.sentry` -- the on-device numeric sentry of the train step: the
  finite check of loss and gradients and a grad-norm and loss-spike
  ladder, packed into one verdict vector that rides the loss's host
  copy; an anomalous update is skipped with bitwise-zero residue (the
  optimizer's ``keep`` select).
* :mod:`.generations` -- checksummed checkpoint generations
  (``gen-<step>/`` and a blake2b manifest, atomic commit, retention) with
  a verified restore that falls back past corrupt or half-written
  generations.

The policy ladder (skip, then rewind) and the chaos verdicts
(``grad_nan``, ``grad_spike``, ``loss_spike``, ``shard_corrupt``,
``kill_mid_write``) are driven end to end by
:class:`hetu_tpu_torch.elastic.FaultTolerantTrainer`.
"""
from .generations import (corrupt_generation, generation_dir,
                          list_generations, load_latest_generation,
                          prune_generations, save_generation,
                          verify_generation, write_manifest)
from .sentry import (INJECT_CODES, VERDICT_SLOTS, NumericSentry,
                     SentryConfig, decode_verdict)

__all__ = [
    "INJECT_CODES", "NumericSentry", "SentryConfig",
    "VERDICT_SLOTS", "corrupt_generation", "decode_verdict",
    "generation_dir", "list_generations", "load_latest_generation",
    "prune_generations", "save_generation", "verify_generation",
    "write_manifest",
]
