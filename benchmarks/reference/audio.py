"""Plain WAV reading and resampling for the reference chain.

``read_wav`` parses a RIFF/WAVE file's ``fmt `` and ``data`` chunks with
numpy (PCM16 only).  ``resample`` is ``scipy.signal.resample_poly`` in
float64 with a Kaiser-windowed sinc low-pass (32 zero-crossings per side at
the lower rate, beta 12.984, rolloff 0.9476), the design the detector
documents for its resampler (librosa's kaiser_best in kind).
"""

from __future__ import annotations

import math
import struct
from typing import Tuple

import numpy as np
import scipy.signal

ZEROS = 32
BETA = 12.984
ROLLOFF = 0.9475937167399596


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """(int16 samples of channel 0, sample rate) of a PCM16 WAV."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    at, fmt, data = 12, None, None
    while at + 8 <= len(raw):
        cid, size = raw[at: at + 4], struct.unpack("<I", raw[at + 4: at + 8])[0]
        body = raw[at + 8: at + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            data = body
        at += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError(f"{path}: no fmt or data chunk")
    tag, channels, sr, _, _, bits = fmt
    if tag != 1 or bits != 16:
        raise ValueError(f"{path}: not PCM16")
    pcm = np.frombuffer(data[: len(data) // (2 * channels) * 2 * channels], "<i2")
    return pcm.reshape(-1, channels)[:, 0].copy(), int(sr)


def kaiser_taps(up: int, down: int) -> np.ndarray:
    max_rate = max(up, down)
    return scipy.signal.firwin(2 * ZEROS * max_rate + 1, ROLLOFF / max_rate,
                               window=("kaiser", BETA))


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """float64 in, float64 out; length ceil(n · target / orig)."""
    if orig_sr == target_sr:
        return np.asarray(x, np.float64)
    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    return scipy.signal.resample_poly(np.asarray(x, np.float64), up, down,
                                      window=kaiser_taps(up, down))
