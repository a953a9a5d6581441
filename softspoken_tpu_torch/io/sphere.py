"""Self-contained NIST SPHERE (``.sph`` / ``.wav``-in-name-only) reader.

SPHERE is the container of the classic speech corpora (TIMIT, Switchboard,
Fisher) — exactly the material a speech-in-field-audio detector gets
pointed at.  The reference reads SPHERE incidentally through libsndfile
(``sf.read``, voice_activity.py:37).

Layout: a fixed-size ASCII header — line 1 ``NIST_1A``, line 2 the header
size as a right-justified decimal (canonically 1024), then
``name -type value`` triplets terminated by ``end_head`` — followed by raw
interleaved samples at the declared offset.  Fields used here:
``channel_count``, ``sample_count``, ``sample_rate``, ``sample_n_bytes``,
``sample_byte_format`` (``01`` little / ``10`` big endian),
``sample_coding`` (``pcm`` or ``ulaw``; ``embedded-shorten`` compressed
payloads are rejected cleanly — decompressing Shorten is out of scope).

``is_sphere``/``info``/``read`` duck-type ``WavInfo`` for ``io.audio``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from . import rawpcm


class SphereFormatError(ValueError):
    pass


_MAGIC = b"NIST_1A"


@dataclass(frozen=True)
class SphereInfo:
    samplerate: int
    channels: int
    frames: int
    subtype: str              # "PCM_8" | "PCM_16" | "PCM_24" | "PCM_32" | "ULAW"
    bits_per_sample: int
    data_offset: int
    data_bytes: int
    little_endian: bool = True

    @property
    def duration(self) -> float:
        return self.frames / float(self.samplerate)


def is_sphere(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(7) == _MAGIC
    except OSError:
        return False


def _parse(f) -> SphereInfo:
    head = f.read(1024)
    if not head.startswith(_MAGIC):
        raise SphereFormatError("not a NIST SPHERE file")
    lines = head.split(b"\n")
    if len(lines) < 3:
        raise SphereFormatError("truncated SPHERE header")
    try:
        hdr_size = int(lines[1].strip())
    except ValueError:
        raise SphereFormatError(f"bad SPHERE header size {lines[1]!r}")
    if hdr_size < 16 or hdr_size > 1 << 20:
        raise SphereFormatError(f"unreasonable SPHERE header size {hdr_size}")
    if hdr_size > len(head):
        head += f.read(hdr_size - len(head))
        if len(head) < hdr_size:
            raise SphereFormatError("truncated SPHERE header")

    fields = {}
    for line in head[:hdr_size].split(b"\n"):
        line = line.strip()
        if line == b"end_head":
            break
        parts = line.split(None, 2)
        if len(parts) == 3 and parts[1][:1] == b"-":
            fields[parts[0].decode("ascii", "replace")] = \
                parts[2].decode("ascii", "replace")

    def _int(name: str, default: Optional[int] = None) -> int:
        v = fields.get(name)
        if v is None:
            if default is None:
                raise SphereFormatError(f"missing SPHERE field {name}")
            return default
        try:
            return int(v)
        except ValueError:
            raise SphereFormatError(f"bad SPHERE field {name}={v!r}")

    channels = _int("channel_count")
    sample_count = _int("sample_count")
    rate = _int("sample_rate")
    nbytes = _int("sample_n_bytes", 2)
    coding = fields.get("sample_coding", "pcm").lower()
    byte_fmt = fields.get("sample_byte_format", "01" if nbytes == 1 else "")

    if "shorten" in coding or "wavpack" in coding:
        raise SphereFormatError(
            f"compressed SPHERE payload ({coding}) is not supported")
    if channels < 1 or channels > 64:
        raise SphereFormatError(f"invalid channel count {channels}")
    if not 1 <= rate <= 10_000_000:
        raise SphereFormatError(f"invalid sample rate {rate}")

    if coding.startswith("ulaw") or coding.startswith("mu-law"):
        if nbytes != 1:
            raise SphereFormatError(f"ulaw with sample_n_bytes={nbytes}")
        subtype = "ULAW"
    elif coding.startswith("pcm"):
        subtype = {1: "PCM_8", 2: "PCM_16", 3: "PCM_24", 4: "PCM_32"}.get(nbytes)
        if subtype is None:
            raise SphereFormatError(f"unsupported sample_n_bytes {nbytes}")
    else:
        raise SphereFormatError(f"unsupported sample_coding {coding!r}")

    if nbytes > 1:
        if byte_fmt == "01":
            little = True
        elif byte_fmt == "10":
            little = False
        else:
            raise SphereFormatError(
                f"unsupported sample_byte_format {byte_fmt!r}")
    else:
        little = True

    try:
        phys = os.fstat(f.fileno()).st_size
    except (OSError, AttributeError):
        pos = f.tell()
        f.seek(0, 2)
        phys = f.tell()
        f.seek(pos)
    bpf = nbytes * channels
    avail = max(0, phys - hdr_size)
    frames = min(sample_count, avail // bpf)  # clamp truncated files
    if sample_count < 0:
        raise SphereFormatError(f"negative sample_count {sample_count}")
    return SphereInfo(
        samplerate=rate, channels=channels, frames=frames, subtype=subtype,
        bits_per_sample=nbytes * 8, data_offset=hdr_size,
        data_bytes=frames * bpf, little_endian=little,
    )


def info(path: str) -> SphereInfo:
    with open(path, "rb") as f:
        return _parse(f)


def _decode(raw: np.ndarray, inf: SphereInfo) -> np.ndarray:
    # _parse only emits ULAW / PCM_8 / PCM_16 / PCM_24 / PCM_32, a subset
    # of what the shared decoder handles
    return rawpcm.decode_pcm(raw, inf.subtype,
                             little_endian=inf.little_endian,
                             error_cls=SphereFormatError)


def read(
    path: str,
    start: int = 0,
    frames: Optional[int] = None,
    always_2d: bool = False,
) -> Tuple[np.ndarray, int]:
    """Float32 samples with the same EOF clamping as ``wavio.read``."""
    return rawpcm.read_clamped(path, _parse, _decode, start, frames,
                               always_2d)
