"""PyTorch's own attention timed on the card: the yardstick beside the
flash kernels, read by ``chip_smoke.py`` (phase 6) and by
``tools/compare_flash_kernels.py`` through this one function.  The port
never calls ``scaled_dot_product_attention``.
"""


def sdpa_times(q, k, v, do, graph_ms, events_ms, causal=True, iters=5):
    """``scaled_dot_product_attention`` on ``[b, s, h, d]`` inputs (its
    default backend for their type), forward and ``torch.autograd.grad``
    through it for the backward against ``do``:

    - ``fwd_ms`` / ``bwd_ms``: CUDA events around the calls, host work
      included (``events_ms(fn, warmup, iters)``);
    - ``fwd_device_ms``: the replays of a CUDA graph of one forward
      (``graph_ms(fn, iters)``);
    - ``bwd_device_ms``: the backward does not capture in a graph of its
      own (autograd runs it against the forward's stream), so the self
      device time of every CUDA kernel that ``iters`` calls launch, summed
      by ``torch.profiler`` (after one warm-up call) over ``iters``;
    - ``bwd_kernels``: that sum by kernel name, in ms a call.

    Needs a CUDA device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
    out = sdpa(qg, kg, vg, is_causal=causal)

    def fwd():
        return sdpa(qt, kt, vt, is_causal=causal)

    def bwd():
        return torch.autograd.grad(out, (qg, kg, vg), dot, retain_graph=True)

    bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            bwd()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us:
                kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3 / iters
    return {"fwd_ms": events_ms(fwd, warmup=3, iters=20),
            "bwd_ms": events_ms(bwd, warmup=3, iters=20),
            "fwd_device_ms": graph_ms(fwd, iters=20),
            "bwd_device_ms": sum(kernels.values()),
            "bwd_kernels": kernels}
