"""Self-contained Apple Core Audio Format (``.caf``) reader.

CAF is Apple's 64-bit container (no 4 GiB limit); macOS-based recording
rigs and Logic/GarageBand exports produce it.  The reference reads CAF
incidentally through libsndfile (``sf.read``, voice_activity.py:37).

Layout (all big-endian): ``caff`` magic + u16 version + u16 flags, then
chunks of 4-char type + i64 size (size of the body only; -1 marks a final
``data`` chunk that extends to EOF).  The mandatory ``desc`` chunk gives
f64 sample rate, 4-char format id, u32 format flags (bit0 = float,
bit1 = little-endian), bytes/packet, frames/packet, channels and
bits/channel.  ``data`` starts with a u32 edit count before the frames.

Supported: ``lpcm`` int 16/24/32 and float 32/64 in either byte order,
signed 8-bit, plus G.711 ``ulaw``/``alaw``.  Compressed format ids are
rejected cleanly.  ``is_caf``/``info``/``read`` duck-type ``WavInfo``.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from . import rawpcm


class CafFormatError(ValueError):
    pass


_FLAG_FLOAT = 1 << 0
_FLAG_LITTLE = 1 << 1


@dataclass(frozen=True)
class CafInfo:
    samplerate: int
    channels: int
    frames: int
    subtype: str              # "PCM_8/16/24/32" | "FLOAT" | "DOUBLE" | "ULAW" | "ALAW"
    bits_per_sample: int
    data_offset: int
    data_bytes: int
    little_endian: bool = False

    @property
    def duration(self) -> float:
        return self.frames / float(self.samplerate)


def is_caf(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            head = f.read(8)
    except OSError:
        return False
    return len(head) == 8 and head[:4] == b"caff"


def _parse(f) -> CafInfo:
    head = f.read(8)
    if len(head) < 8 or head[:4] != b"caff":
        raise CafFormatError("not a CAF file")

    rate = 0.0
    fmt_id = b""
    flags = bpp = fpp = channels = bits = 0
    data_offset: Optional[int] = None
    data_bytes = 0
    try:
        phys = os.fstat(f.fileno()).st_size
    except (OSError, AttributeError):
        pos = f.tell()
        f.seek(0, 2)
        phys = f.tell()
        f.seek(pos)

    while True:
        hdr = f.read(12)
        if len(hdr) < 12:
            break
        ctype = hdr[:4]
        (csize,) = struct.unpack(">q", hdr[4:12])
        here = f.tell()
        if ctype == b"desc":
            body = f.read(32)
            if len(body) < 32:
                raise CafFormatError("truncated desc chunk")
            rate = struct.unpack(">d", body[:8])[0]
            fmt_id = body[8:12]
            flags, bpp, fpp, channels, bits = struct.unpack(">5I", body[12:32])
        elif ctype == b"data" and data_offset is None:
            if csize == -1:  # final chunk, extends to EOF
                data_offset = here + 4  # u32 edit count precedes the frames
                data_bytes = max(0, phys - data_offset)
                break
            if csize < 4:
                raise CafFormatError("data chunk smaller than its edit count")
            data_offset = here + 4
            data_bytes = csize - 4
        if csize < 0:
            raise CafFormatError(f"negative chunk size {csize}")
        f.seek(here + csize)

    if not fmt_id:
        raise CafFormatError("missing desc chunk")
    if data_offset is None:
        raise CafFormatError("missing data chunk")
    if not (1.0 <= rate <= 1e7):
        raise CafFormatError(f"invalid sample rate {rate}")
    if channels < 1 or channels > 1024:
        raise CafFormatError(f"invalid channel count {channels}")

    little = bool(flags & _FLAG_LITTLE)
    if fmt_id == b"lpcm":
        if fpp != 1 or bpp != channels * (bits // 8) or bits % 8:
            raise CafFormatError(
                f"non-packed lpcm layout (bpp={bpp} fpp={fpp} bits={bits})")
        if flags & _FLAG_FLOAT:
            subtype = {32: "FLOAT", 64: "DOUBLE"}.get(bits)
        else:
            subtype = {8: "PCM_8", 16: "PCM_16", 24: "PCM_24",
                       32: "PCM_32"}.get(bits)
        if subtype is None:
            raise CafFormatError(f"unsupported lpcm bits={bits}")
    elif fmt_id in (b"ulaw", b"alaw"):
        subtype = fmt_id.decode().upper()
        bits = 8
        bpp = channels
    else:
        raise CafFormatError(f"unsupported CAF format id {fmt_id!r}")

    data_bytes = max(0, min(data_bytes, phys - data_offset))
    frames = data_bytes // bpp
    return CafInfo(
        samplerate=int(round(rate)), channels=channels, frames=frames,
        subtype=subtype, bits_per_sample=bits, data_offset=data_offset,
        data_bytes=frames * bpp, little_endian=little,
    )


def info(path: str) -> CafInfo:
    with open(path, "rb") as f:
        return _parse(f)


def _decode(raw: np.ndarray, inf: CafInfo) -> np.ndarray:
    return rawpcm.decode_pcm(raw, inf.subtype,
                             little_endian=inf.little_endian,
                             error_cls=CafFormatError)


def read(
    path: str,
    start: int = 0,
    frames: Optional[int] = None,
    always_2d: bool = False,
) -> Tuple[np.ndarray, int]:
    """Float32 samples with the same EOF clamping as ``wavio.read``."""
    return rawpcm.read_clamped(path, _parse, _decode, start, frames,
                               always_2d)
