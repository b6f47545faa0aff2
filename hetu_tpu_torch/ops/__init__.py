"""Operators of the port.  Each kernel's module holds its plain PyTorch
version, its CUDA wrapper and the dispatcher between them, e.g.
``hetu_tpu_torch.ops.ragged_paged_attention``."""
