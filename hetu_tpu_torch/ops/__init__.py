"""Operators of the port.  ``functional`` holds the ops the models record
on a graph; each kernel's module holds its plain PyTorch version, its
CUDA wrappers and the dispatcher between them, e.g.
``hetu_tpu_torch.ops.flash_attention``.  Only ``paged_attention_decode``
is re-exported (as ``hetu_tpu.ops`` exports it): its name differs from
its submodule's, whereas a function named like a submodule
(``attention``) would hide it."""
from .paged_attention import paged_attention_decode

__all__ = ["paged_attention_decode"]
