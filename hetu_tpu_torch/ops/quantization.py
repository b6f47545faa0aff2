"""Absmax quantization: int8 / nf4 / fp4 (PyTorch port of
``hetu_tpu.ops.quantization``).

``quantize_rows`` quantizes ``[..., d]`` vectors with one absmax scale
per row, so a paged KV pool can keep one scale per cached token (the
serving engine's ``page_quant``).  The codes are bit-equal to the JAX
package's, because KV pages and checkpoints carry them:

- ``absmax == 0`` scales by 1;
- int8 is ``clip(round(x / scale * 127), -127, 127)`` with round half
  to even;
- 4-bit codes take the nearest codebook entry, the first of equal
  distances (fp4 holds ``0.0`` and ``-0.0`` at indices 0 and 8), and pack
  two to a byte with the even element in the high nibble.

The blockwise ``quantize_4bit`` / ``quantize_int8`` flatten the tensor,
zero-pad it to whole blocks and keep one absmax a block (the layout of
the checkpoints' quantized save); their codes follow the same rules.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

# 16-entry codebooks, index = 4-bit code.
FP4_CODE = np.array(
    [0.0, 0.0052083333, 0.6666666667, 1.0, 0.3333333333, 0.5,
     0.1666666667, 0.25,
     -0.0, -0.0052083333, -0.6666666667, -1.0, -0.3333333333, -0.5,
     -0.1666666667, -0.25], dtype=np.float32)

NF4_CODE = np.array(
    [-1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
     -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
     0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
     0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
     0.7229568362236023, 1.0], dtype=np.float32)

_CODES = {"fp4": FP4_CODE, "nf4": NF4_CODE}


@functools.lru_cache(maxsize=None)
def _codebook(quant: str, device: torch.device) -> torch.Tensor:
    """The codebook on ``device``, copied there once: a captured serving
    step reads this tensor and issues no host copy."""
    return torch.from_numpy(_CODES[quant]).to(device)


def quantize_rows(x: torch.Tensor, quant: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax quantize of ``[..., d]`` vectors.

    Returns ``(codes, absmax)``: codes are int8 ``[..., d]`` for
    ``"int8"`` or packed uint8 ``[..., d//2]`` for ``"nf4"``/``"fp4"``
    (d must be even); absmax is float32 ``[..., 1]``."""
    x = x.to(torch.float32)
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    if quant == "int8":
        q = torch.clamp(torch.round(x / scale * 127.0), -127, 127)
        return q.to(torch.int8), absmax
    if quant in ("nf4", "fp4"):
        if x.shape[-1] % 2:
            raise ValueError(f"4-bit rows need even width, got "
                             f"{x.shape[-1]}")
        code = _codebook(quant, x.device)
        # torch.argmin returns the first minimum, as jnp.argmin does
        idx = torch.argmin(((x / scale)[..., None] - code).abs(),
                           dim=-1).to(torch.uint8)
        packed = (idx[..., 0::2] << 4) | idx[..., 1::2]
        return packed, absmax
    raise ValueError(f"unknown row quant {quant!r}")


def dequantize_rows(codes: torch.Tensor, absmax: torch.Tensor, quant: str,
                    d: int, dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`: codes ``[..., w]`` + absmax
    ``[..., 1]`` -> ``[..., d]``."""
    scale = torch.where(absmax > 0, absmax,
                        torch.ones_like(absmax)).to(torch.float32)
    if quant == "int8":
        return (codes.to(torch.float32) / 127.0 * scale).to(dtype)
    if quant in ("nf4", "fp4"):
        code = _codebook(quant, codes.device)
        hi = (codes >> 4).long()
        lo = (codes & 0xF).long()
        idx = torch.stack([hi, lo], dim=-1).reshape(*codes.shape[:-1], d)
        return (code[idx] * scale).to(dtype)
    raise ValueError(f"unknown row quant {quant!r}")


# ---------------------------------------------------------------------------
# blockwise (the checkpoints' quantized save)
# ---------------------------------------------------------------------------

def _blocked(x: torch.Tensor, blocksize: int) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % blocksize
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, blocksize)


def _numel(shape: Sequence[int]) -> int:
    return int(np.prod(shape)) if len(shape) else 1


def quantize_4bit(x, quant_type: str = "nf4", blocksize: int = 64
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise 4-bit quantize.  Returns (packed uint8 of length
    ceil(n/2), absmax per block as float32)."""
    x = torch.as_tensor(x).to(torch.float32)
    blocks = _blocked(x, blocksize)
    absmax = blocks.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    code = _codebook(quant_type, x.device)
    idx = torch.argmin(((blocks / scale[:, None])[..., None] - code).abs(),
                       dim=-1).to(torch.uint8).reshape(-1)
    return (idx[0::2] << 4) | idx[1::2], absmax


def dequantize_4bit(packed, absmax, shape, quant_type: str = "nf4",
                    blocksize: int = 64, dtype=torch.float32
                    ) -> torch.Tensor:
    """Inverse of :func:`quantize_4bit` (original ``shape`` required)."""
    packed = torch.as_tensor(packed)
    absmax = torch.as_tensor(absmax)
    code = _codebook(quant_type, packed.device)
    idx = torch.stack([(packed >> 4).long(), (packed & 0xF).long()],
                      dim=1).reshape(-1)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    vals = code[idx].reshape(-1, blocksize) * scale[:, None]
    return vals.reshape(-1)[:_numel(shape)].reshape(tuple(shape)).to(dtype)


def quantize_int8(x, blocksize: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 absmax quantize -> (int8 codes, absmax)."""
    x = torch.as_tensor(x).to(torch.float32)
    blocks = _blocked(x, blocksize)
    absmax = blocks.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    q = torch.clamp(torch.round(blocks / scale[:, None] * 127.0), -127, 127)
    return q.to(torch.int8).reshape(-1), absmax


def dequantize_int8(q, absmax, shape, blocksize: int = 256,
                    dtype=torch.float32) -> torch.Tensor:
    q = torch.as_tensor(q).to(torch.float32).reshape(-1, blocksize)
    absmax = torch.as_tensor(absmax)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    vals = q / 127.0 * scale[:, None]
    return vals.reshape(-1)[:_numel(shape)].reshape(tuple(shape)).to(dtype)
