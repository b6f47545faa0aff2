"""Operators of the port.  ``functional`` holds the ops the models record
on a graph; each kernel's module holds its plain PyTorch version, its
CUDA wrappers and the dispatcher between them, e.g.
``hetu_tpu_torch.ops.flash_attention``.  Nothing is re-exported here: a
function named like a submodule (``attention``) would hide it."""
