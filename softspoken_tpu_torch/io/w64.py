"""Self-contained Sony Wave64 (``.w64``) reader.

Wave64 is the 64-bit RIFF variant field recorders (Sound Devices, Zoom)
roll over to when a take exceeds RIFF's 4 GiB limit — the other common
answer besides RF64, which ``io/wavio.py`` already reads and writes.  The
reference reads W64 incidentally through libsndfile (``sf.read``,
voice_activity.py:37).

Layout: 16-byte GUID chunk ids instead of FourCCs, 64-bit little-endian
sizes that INCLUDE the 24-byte chunk header, chunks aligned to 8 bytes.
The ``fmt `` body is the same WAVEFORMAT(EXTENSIBLE) structure as WAV, so
subtype mapping and sample decode are shared with ``io/wavio.py``.

``is_w64``/``info``/``read`` duck-type ``WavInfo`` for ``io.audio``
dispatch.  PCM and float subtypes are supported; block-coded (ADPCM)
payloads are rejected cleanly (they do not occur in W64 field recordings).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from . import rawpcm, wavio

_SUFFIX_RIFF = bytes.fromhex("2e91cf11a5d628db04c10000")
_SUFFIX_W64 = bytes.fromhex("f3acd3118cd100c04f8edb8a")
GUID_RIFF = b"riff" + _SUFFIX_RIFF
GUID_WAVE = b"wave" + _SUFFIX_W64
GUID_FMT = b"fmt " + _SUFFIX_W64
GUID_DATA = b"data" + _SUFFIX_W64


class W64FormatError(ValueError):
    pass


@dataclass(frozen=True)
class W64Info:
    samplerate: int
    channels: int
    frames: int
    subtype: str              # same names as wavio ("PCM_16", "FLOAT", ...)
    bits_per_sample: int
    data_offset: int
    data_bytes: int

    @property
    def duration(self) -> float:
        return self.frames / float(self.samplerate)


def is_w64(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            head = f.read(40)
    except OSError:
        return False
    return (len(head) == 40 and head[:16] == GUID_RIFF
            and head[24:40] == GUID_WAVE)


def _parse(f) -> W64Info:
    head = f.read(40)
    if len(head) < 40 or head[:16] != GUID_RIFF or head[24:40] != GUID_WAVE:
        raise W64FormatError("not a Wave64 file")

    fmt_tag = channels = samplerate = bits = None
    data_offset = data_bytes = None
    while True:
        hdr = f.read(24)
        if len(hdr) < 24:
            break
        guid = hdr[:16]
        (csize,) = struct.unpack("<Q", hdr[16:24])
        if csize < 24:
            raise W64FormatError(f"chunk size {csize} smaller than its header")
        body_size = csize - 24
        here = f.tell()
        if guid == GUID_FMT:
            body = f.read(min(body_size, 64))
            if len(body) < 16:
                raise W64FormatError("truncated fmt chunk")
            fmt_tag, channels, samplerate, _brate, _balign, bits = \
                struct.unpack("<HHIIHH", body[:16])
            if fmt_tag == wavio.WAVE_FORMAT_EXTENSIBLE:
                if len(body) < 26:
                    raise W64FormatError(
                        "truncated WAVE_FORMAT_EXTENSIBLE fmt chunk")
                # SubFormat GUID: first two bytes are the real format tag
                fmt_tag = struct.unpack("<H", body[24:26])[0]
        elif guid == GUID_DATA and data_offset is None:
            # first-wins, mirroring wavio._parse_header
            data_offset = here
            data_bytes = body_size
        # sizes include the header; payloads are aligned UP to 8 bytes
        f.seek(here + body_size + (-body_size % 8))

    if fmt_tag is None or data_offset is None:
        raise W64FormatError("missing fmt or data chunk")
    key = (fmt_tag, bits)
    subtype = wavio._SUBTYPE_BY_FMT.get(key)
    if subtype is None or subtype in wavio.BLOCK_SUBTYPES:
        raise W64FormatError(
            f"unsupported W64 format tag={fmt_tag} bits={bits}")
    bpf = channels * (bits // 8)
    if bpf <= 0 or samplerate <= 0:
        raise W64FormatError(
            f"invalid fmt chunk: channels={channels} bits={bits} "
            f"samplerate={samplerate}")
    # clamp against the physical payload (recorder-crash truncation)
    try:
        phys = os.fstat(f.fileno()).st_size - data_offset
    except (OSError, AttributeError):
        pos = f.tell()
        f.seek(0, 2)
        phys = f.tell() - data_offset
        f.seek(pos)
    data_bytes = max(0, min(data_bytes, phys))
    frames = data_bytes // bpf
    return W64Info(
        samplerate=samplerate, channels=channels, frames=frames,
        subtype=subtype, bits_per_sample=bits, data_offset=data_offset,
        data_bytes=frames * bpf,
    )


def info(path: str) -> W64Info:
    with open(path, "rb") as f:
        return _parse(f)


def read(
    path: str,
    start: int = 0,
    frames: Optional[int] = None,
    always_2d: bool = False,
) -> Tuple[np.ndarray, int]:
    """Float32 samples with the same EOF clamping as ``wavio.read``."""
    # same little-endian payload encodings as WAV (incl. UNSIGNED 8-bit),
    # so the sample decode is wavio's, not rawpcm's signed-PCM_8 one
    return rawpcm.read_clamped(
        path, _parse, lambda raw, inf: wavio._decode(raw, inf.subtype),
        start, frames, always_2d)
