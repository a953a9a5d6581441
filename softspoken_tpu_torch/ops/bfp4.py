"""4-bit block-floating-point codec.

A copy of the JAX package's ``ops/bfp4.py``.  Samples are
grouped into blocks of ``BLOCK``; each block is scaled by its peak
magnitude and quantized to 15 uniform levels (4-bit signed, two codes per
byte) with one int16 scale per block.  The JAX package measured it as a
wire and rejected it (out-of-family event F1 collapses), so it lives on
as the degradation grid's ``bfp4`` condition (``train/degrade.py``);
``decode_device`` keeps the module whole and lies on no path.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 256          # samples per scale block
QMAX = 7             # 4-bit signed codes in [-7, 7] (15 levels, mid-tread)


def encode_i16(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int16 samples -> (packed uint8 codes (ceil(n/2),), int16 scales).

    ``n`` is padded up to a whole block with zeros; zero blocks get scale 1
    so decode stays exact-zero.  Packing: sample 2k -> low nibble of byte
    k, sample 2k+1 -> high nibble.
    """
    if x.dtype != np.int16:
        raise TypeError(f"encode requires int16 PCM, got {x.dtype}")
    n = len(x)
    nb = -(-max(n, 1) // BLOCK)
    xp = np.zeros(nb * BLOCK, np.int16)
    xp[:n] = x
    blocks = xp.reshape(nb, BLOCK).astype(np.int32)
    scales = np.abs(blocks).max(axis=1).astype(np.int32)
    # clamp to the int16 range: a full-scale -32768 sample would otherwise
    # wrap the scale to -32768 and negate its whole block
    scales = np.clip(scales, 1, 32767)
    q = np.rint(blocks * (float(QMAX)) / scales[:, None]).astype(np.int32)
    q = np.clip(q, -QMAX, QMAX).reshape(-1)
    u = (q & 0xF).astype(np.uint8)
    packed = (u[0::2] | (u[1::2] << 4)).astype(np.uint8)
    return packed, scales.astype(np.int16)


def decode_host(packed: np.ndarray, scales: np.ndarray,
                n: int) -> np.ndarray:
    """Reference decode: -> float32 in [-1, 1] (length n)."""
    b = packed.astype(np.int16)
    lo = ((b & 0xF) ^ 8) - 8          # sign-extend low nibble
    hi = ((b >> 4) ^ 8) - 8
    q = np.empty(2 * len(b), np.int16)
    q[0::2] = lo
    q[1::2] = hi
    nb = len(scales)
    vals = q[: nb * BLOCK].reshape(nb, BLOCK).astype(np.float64)
    vals = vals * (scales.astype(np.float64)[:, None] / (QMAX * 32768.0))
    return vals.reshape(-1)[:n].astype(np.float32)


def roundtrip_i16(x: np.ndarray) -> np.ndarray:
    """int16 -> codec round trip -> float32 (for the degradation grid)."""
    packed, scales = encode_i16(x)
    return decode_host(packed, scales, len(x))


def decode_device(packed: torch.Tensor, scales: torch.Tensor, n: int) -> torch.Tensor:
    """(ceil(n/2),) int8 codes + (nb,) int16 scales -> (n,) float32 on their
    device (plain torch shifts and products)."""
    b = packed.to(torch.int32)
    lo = ((b & 0xF) ^ 8) - 8
    # mask AFTER the shift: the wire bytes are signed int8, so >> 4 of a
    # negative byte fills the high bits with ones
    hi = (((b >> 4) & 0xF) ^ 8) - 8
    q = torch.stack([lo, hi], dim=1).reshape(-1)       # interleave
    nb = scales.shape[0]
    vals = q[: nb * BLOCK].reshape(nb, BLOCK).to(torch.float32)
    vals = vals * (scales.to(torch.float32)[:, None] * (1.0 / (QMAX * 32768.0)))
    return vals.reshape(-1)[:n]
