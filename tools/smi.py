"""The card's clocks beside a measurement: ``nvidia-smi`` sampled while a
context is open (no repository imports, so a tool can use it before it
imports a checkout)."""
import contextlib
import subprocess
import time

import numpy as np


@contextlib.contextmanager
def clocks(into: dict, busy=None, min_s: float = 0.6):
    """Samples ``nvidia-smi``'s SM clock and power draw every 250 ms
    while the context is open; writes min/median/max into ``into``.  With
    ``busy`` (a callable that runs the measured work once and waits for
    the card), it is called again after the body until ``min_s`` seconds
    have passed, so that a reading shorter than the sampling interval
    still has samples taken under its own load."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "250"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield
        while busy is not None and time.perf_counter() - t0 < min_s:
            busy()
    finally:
        proc.terminate()
        text, _ = proc.communicate(timeout=30)
        rows = [[float(x) for x in line.split(",")]
                for line in text.splitlines() if line.count(",") == 1]
        for i, name in enumerate(("sm_clock_mhz", "power_w")):
            vals = sorted(r[i] for r in rows)
            into[name] = ([vals[0], float(np.median(vals)), vals[-1]]
                          if vals else None)
