"""Capped-exponential retry/backoff with deterministic jitter (port of
``hetu_tpu.fault.backoff``, pure Python: the delays are the JAX
package's bit for bit).

A backpressured KV handoff and a refused heartbeat both retry through
:class:`RetryPolicy`: capped exponential backoff with *deterministic*
jitter (hashed from ``(key, attempt)``, no RNG state), so two replays of
the same seeded chaos schedule retry at identical instants.  Deadlines
are the other half: :meth:`RetryPolicy.deadline_for` stamps a
per-request give-up time, past which callers degrade (re-route, shed
with a retriable rejection, fall back to monolithic serving) instead of
spinning.
"""
from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass
from typing import Optional


def unit_hash(*keys: int) -> float:
    """Deterministic uniform in [0, 1) from integer keys — the jitter
    source.  Hash-based (blake2b), not RNG-state-based: concurrent
    retry chains can't perturb each other's jitter sequence."""
    h = hashlib.blake2b(struct.pack(f"<{len(keys)}q", *keys),
                        digest_size=8).digest()
    return struct.unpack("<Q", h)[0] / 2.0 ** 64


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff: attempt ``k`` (0-based) waits
    ``min(cap, base * multiplier**k)`` seconds, jittered ±``jitter``
    fraction deterministically by ``(key, k)``.

    ``deadline`` is the per-request retry budget in seconds (measured
    from the request's submit time); ``None`` disables the give-up path
    (retry forever).  Time units are whatever clock the caller
    runs — the serving cluster's synthetic test clocks included.
    """

    base: float = 0.5
    cap: float = 8.0
    multiplier: float = 2.0
    jitter: float = 0.25
    deadline: Optional[float] = None

    def delay(self, attempt: int, key: int = 0) -> float:
        d = min(float(self.cap),
                float(self.base) * float(self.multiplier) ** max(0, attempt))
        if self.jitter:
            u = unit_hash(int(key), int(attempt))
            d *= 1.0 + float(self.jitter) * (2.0 * u - 1.0)
        return d

    def deadline_for(self, start: float) -> Optional[float]:
        return None if self.deadline is None \
            else float(start) + float(self.deadline)

    def expired(self, start: float, now: float) -> bool:
        return self.deadline is not None \
            and now - float(start) > float(self.deadline)
