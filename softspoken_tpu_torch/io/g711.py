"""G.711 companding decode tables (mu-law / A-law), host side.

Shared by the AU (``io/au.py``), NIST SPHERE (``io/sphere.py``) and CAF
(``io/caf.py``) readers — telephony-era speech corpora ship these
encodings and the reference reads them incidentally through libsndfile
(``sf.read``, voice_activity.py:37).

These are the *decode* tables for stored 8-bit codes.  The upload
compander of the lossy mu-law wire (``ops/mulaw.py``) is a separate
continuous-formula codec for the host->device wire; it is not
byte-compatible with G.711 and the two must not be mixed.
"""

from __future__ import annotations

import numpy as np


def _build_ulaw_table() -> np.ndarray:
    c = np.arange(256, dtype=np.int32) ^ 0xFF  # stored codes are inverted
    sign = (c & 0x80) != 0
    exp = (c >> 4) & 0x7
    mant = c & 0x0F
    mag = (((mant << 3) + 0x84) << exp) - 0x84
    return np.where(sign, -mag, mag).astype(np.int16)


def _build_alaw_table() -> np.ndarray:
    a = np.arange(256, dtype=np.int32) ^ 0x55  # even bits inverted on wire
    sign = (a & 0x80) != 0
    seg = (a >> 4) & 0x7
    mant = a & 0x0F
    mag = np.where(seg == 0, (mant << 4) + 8,
                   ((mant << 4) + 0x108) << np.maximum(seg - 1, 0))
    # A-law sign bit SET means positive (opposite of mu-law)
    return np.where(sign, mag, -mag).astype(np.int16)


ULAW_TABLE = _build_ulaw_table()   # code -> int16 in [-32124, 32124]
ALAW_TABLE = _build_alaw_table()   # code -> int16 in [-32256, 32256]


def ulaw_to_i16(codes: np.ndarray) -> np.ndarray:
    """Vectorized G.711 mu-law decode: uint8 codes -> int16 samples."""
    return ULAW_TABLE[np.asarray(codes, dtype=np.uint8)]


def alaw_to_i16(codes: np.ndarray) -> np.ndarray:
    """Vectorized G.711 A-law decode: uint8 codes -> int16 samples."""
    return ALAW_TABLE[np.asarray(codes, dtype=np.uint8)]


def ulaw_to_f32(codes: np.ndarray) -> np.ndarray:
    return ulaw_to_i16(codes).astype(np.float32) / 32768.0


def alaw_to_f32(codes: np.ndarray) -> np.ndarray:
    return alaw_to_i16(codes).astype(np.float32) / 32768.0
