"""8-bit mu-law compander, host half.

A copy of the JAX package's ``ops/mulaw.py`` host functions: the 64 Ki
entry encode table (int16 bit pattern -> int8 code), the encode gather and
the numpy reference decode.  The degradation grid's ``mulaw`` condition
(``train/degrade.py``) runs a recording through them.  The device decode
belongs to the mu-law upload wire, which is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np

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


def encode_i16(x: np.ndarray) -> np.ndarray:
    """int16 PCM -> int8 mu-law codes (one table gather; 0 encodes to 0)."""
    # not `assert`: a wrong dtype would compand garbage under `python -O`
    if x.dtype != np.int16:
        raise TypeError(f"encode_i16 requires int16 PCM, got {x.dtype}")
    return encode_lut()[x.view(np.uint16)]


def decode_host(q: np.ndarray) -> np.ndarray:
    """Reference decode (numpy, float64 -> float32)."""
    y = q.astype(np.float64) / 127.0
    return (np.sign(y) * np.expm1(np.abs(y) * _LOG1P_MU) / MU).astype(np.float32)
