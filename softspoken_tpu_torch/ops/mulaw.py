"""8-bit mu-law compander: the mulaw8 upload wire and the ``mulaw``
degradation.

A copy of the JAX package's ``ops/mulaw.py``: the 64 Ki entry encode table
(int16 bit pattern -> int8 code), the encode gather (the native
``ss_mulaw_encode_i16`` loop of ``io/native.py`` when it is built, else
numpy; both read the same table), the device decode and the numpy
reference decode.  The fused engine's mulaw8 wire encodes on the host and
decodes with ``decode_device`` on the detector's device, in place of the
int16 ``x / 32768`` scale.
"""

from __future__ import annotations

import numpy as np
import torch

MU = 255.0
_LOG1P_MU = float(np.log1p(MU))

# worst-case round-trip error of round-to-nearest 8-bit mu-law on [-1, 1]:
# half a code step at |x| -> 1; measured max over all 65536 int16 codes:
# 0.02167.
MAX_ABS_ERROR = 0.022

_ENC_LUT: np.ndarray | None = None


def encode_lut() -> np.ndarray:
    """(65536,) int8 mu-law code per int16 *bit pattern* (uint16 index)."""
    global _ENC_LUT
    if _ENC_LUT is None:
        signed = np.arange(65536, dtype=np.uint16).view(np.int16)
        x = signed.astype(np.float64) / 32768.0
        y = np.sign(x) * np.log1p(MU * np.abs(x)) / _LOG1P_MU
        _ENC_LUT = np.round(y * 127.0).astype(np.int8)
    return _ENC_LUT


def encode_i16(x: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """int16 PCM -> int8 mu-law codes (one table gather; 0 encodes to 0).

    ``out`` (a contiguous int8 buffer of length ``len(x)``) lets the fused
    engine encode straight into its staging buffer.
    """
    # not `assert`: a wrong dtype would compand garbage under `python -O`
    if x.dtype != np.int16:
        raise TypeError(f"encode_i16 requires int16 PCM, got {x.dtype}")
    lut = encode_lut()
    from ..io.native import mulaw_encode_i16

    q = mulaw_encode_i16(x, lut, out=out)
    if q is not None:
        return q
    if out is not None:
        np.take(lut, x.view(np.uint16), out=out)
        return out
    return lut[x.view(np.uint16)]


def decode_device(q: torch.Tensor) -> torch.Tensor:
    """int8 codes -> float32 in [-1, 1] on ``q``'s device: the JAX
    ``decode_device`` formula in float32 (sign, abs, expm1, products).
    Plain torch: elementwise work that the JAX package left to XLA."""
    y = q.to(torch.float32) * (1.0 / 127.0)
    return torch.sign(y) * (torch.expm1(torch.abs(y) * _LOG1P_MU) * (1.0 / MU))


def decode_host(q: np.ndarray) -> np.ndarray:
    """Reference decode (numpy, float64 -> float32)."""
    y = q.astype(np.float64) / 127.0
    return (np.sign(y) * np.expm1(np.abs(y) * _LOG1P_MU) / MU).astype(np.float32)
