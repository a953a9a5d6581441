"""Self-contained Sun/NeXT AU (``.au`` / ``.snd``) reader.

The reference reads AU incidentally through libsndfile (``sf.read``,
voice_activity.py:37); telephony and old speech corpora still ship it.
Same from-scratch-codec pattern as ``io/wavio.py`` / ``io/aiff.py``:
``is_au``/``info``/``read`` duck-typing ``WavInfo`` so ``io.audio.probe``
and ``read_any`` dispatch transparently.

Format: 24-byte big-endian header — magic ``.snd``, data offset, data
size (``0xFFFFFFFF`` = unknown, extends to EOF), encoding, sample rate,
channels — then interleaved big-endian frames.  Supported encodings:
G.711 mu-law (1), signed PCM 8/16/24/32 (2-5), float32/64 (6-7) and
G.711 A-law (27); compressed encodings are rejected cleanly.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from . import rawpcm


class AuFormatError(ValueError):
    pass


_MAGIC = b".snd"

#: encoding id -> (subtype, bytes per sample)
_ENCODINGS = {
    1: ("ULAW", 1),
    2: ("PCM_8", 1),      # AU 8-bit PCM is SIGNED (unlike WAV's PCM_U8)
    3: ("PCM_16", 2),
    4: ("PCM_24", 3),
    5: ("PCM_32", 4),
    6: ("FLOAT", 4),
    7: ("DOUBLE", 8),
    27: ("ALAW", 1),
}


@dataclass(frozen=True)
class AuInfo:
    samplerate: int
    channels: int
    frames: int
    subtype: str
    bits_per_sample: int
    data_offset: int
    data_bytes: int

    @property
    def duration(self) -> float:
        return self.frames / float(self.samplerate)


def is_au(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(4) == _MAGIC
    except OSError:
        return False


def _parse(f) -> AuInfo:
    head = f.read(24)
    if len(head) < 24 or head[:4] != _MAGIC:
        raise AuFormatError("not an AU file")
    offset, size, enc, rate, channels = struct.unpack(">5I", head[4:24])
    if offset < 24:
        raise AuFormatError(f"data offset {offset} inside the header")
    if enc not in _ENCODINGS:
        raise AuFormatError(f"unsupported AU encoding {enc}")
    if channels < 1 or channels > 1024:
        raise AuFormatError(f"invalid channel count {channels}")
    if not 1 <= rate <= 10_000_000:
        raise AuFormatError(f"invalid sample rate {rate}")
    subtype, bps = _ENCODINGS[enc]
    try:
        phys = os.fstat(f.fileno()).st_size
    except (OSError, AttributeError):
        pos = f.tell()
        f.seek(0, 2)
        phys = f.tell()
        f.seek(pos)
    avail = max(0, phys - offset)
    # 0xFFFFFFFF = "unknown, read to EOF"; also clamp a stale/overstated
    # size against the physical payload (crash-truncated files)
    data_bytes = avail if size == 0xFFFFFFFF else min(size, avail)
    bpf = bps * channels
    return AuInfo(
        samplerate=rate, channels=channels, frames=data_bytes // bpf,
        subtype=subtype, bits_per_sample=bps * 8, data_offset=offset,
        data_bytes=data_bytes,
    )


def info(path: str) -> AuInfo:
    with open(path, "rb") as f:
        return _parse(f)


def _decode(raw: np.ndarray, inf: AuInfo) -> np.ndarray:
    # AU payloads are always big-endian
    return rawpcm.decode_pcm(raw, inf.subtype, little_endian=False,
                             error_cls=AuFormatError)


def read(
    path: str,
    start: int = 0,
    frames: Optional[int] = None,
    always_2d: bool = False,
) -> Tuple[np.ndarray, int]:
    """Float32 samples with the same EOF clamping as ``wavio.read``."""
    return rawpcm.read_clamped(path, _parse, _decode, start, frames,
                               always_2d)
