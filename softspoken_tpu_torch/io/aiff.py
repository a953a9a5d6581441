"""Self-contained AIFF / AIFF-C reader.

The reference gets incidental AIFF support through libsndfile
(``sf.read``, voice_activity.py:37); field recorders and Mac toolchains
still emit it.  Like ``io/wavio.py`` this is a from-scratch codec (no
third-party deps): FORM/COMM/SSND chunk walk, the 80-bit extended-float
sample rate, big-endian PCM (AIFF) and the common AIFF-C compression tags
``NONE`` (BE) / ``sowt`` (LE PCM16) / ``fl32``/``FL32`` (BE float32) /
``ulaw``/``alaw`` (G.711, 1 byte per sample on disk; COMM sampleSize
describes the DECODED width, so frame addressing uses the container).

API mirrors ``wavio``: ``info(path) -> AiffInfo`` (duck-types WavInfo) and
``read(path, start=, frames=, always_2d=) -> (float32, samplerate)`` with
EOF clamping, so ``io.audio.probe``/``read_any`` dispatch transparently.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


class AiffFormatError(ValueError):
    pass


@dataclass(frozen=True)
class AiffInfo:
    samplerate: int
    channels: int
    frames: int
    subtype: str              # "PCM_8/16/24/32" | "FLOAT" | "ULAW" | "ALAW"
    bits_per_sample: int
    data_offset: int          # byte offset of the first sample frame
    data_bytes: int
    little_endian: bool = False
    # stored bytes per sample when it differs from bits//8 (G.711: COMM
    # sampleSize says 16 but the SSND holds 1-byte codes); 0 = bits//8
    container_bytes: int = 0

    @property
    def bytes_per_sample(self) -> int:
        return self.container_bytes or (self.bits_per_sample // 8)

    @property
    def duration(self) -> float:
        return self.frames / float(self.samplerate)


def is_aiff(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            head = f.read(12)
    except OSError:
        return False
    return (
        len(head) == 12
        and head[:4] == b"FORM"
        and head[8:12] in (b"AIFF", b"AIFC")
    )


def _extended80(b: bytes) -> float:
    """IEEE 754 80-bit extended float (the COMM sampleRate field)."""
    if len(b) != 10:
        raise AiffFormatError("bad extended float")
    (se,) = struct.unpack(">H", b[:2])
    (mant,) = struct.unpack(">Q", b[2:])
    sign = -1.0 if se & 0x8000 else 1.0
    exp = se & 0x7FFF
    if exp == 0 and mant == 0:
        return 0.0
    if exp == 0x7FFF or not 16383 - 64 <= exp <= 16383 + 64:
        # inf/NaN encodings, and exponents far outside any audio rate —
        # AiffFormatError, not OverflowError from the 2.0** below, so
        # probe()/read_any() format dispatch keeps working
        raise AiffFormatError(f"unreasonable sampleRate exponent {exp}")
    return sign * mant * 2.0 ** (exp - 16383 - 63)


def _parse(f) -> AiffInfo:
    head = f.read(12)
    if len(head) < 12 or head[:4] != b"FORM" or head[8:12] not in (b"AIFF", b"AIFC"):
        raise AiffFormatError("not an AIFF/AIFC file")
    is_aifc = head[8:12] == b"AIFC"

    channels = frames = bits = 0
    rate = 0.0
    comp = b"NONE"
    # None = no SSND seen; 0 is a VALID empty SSND payload — conflating the
    # two decoded header/trailing bytes as PCM
    data_offset: int | None = None
    data_bytes = 0
    while True:
        ck = f.read(8)
        if len(ck) < 8:
            break
        cid, size = ck[:4], struct.unpack(">I", ck[4:])[0]
        here = f.tell()
        if cid == b"COMM":
            body = f.read(size)
            if len(body) < 18:
                raise AiffFormatError("short COMM chunk")
            channels, frames, bits = struct.unpack(">hIh", body[:8])
            rate = _extended80(body[8:18])
            if is_aifc and len(body) >= 22:
                comp = body[18:22]
        elif cid == b"SSND":
            body = f.read(8)
            if len(body) < 8:
                raise AiffFormatError("short SSND chunk")
            offset, _block = struct.unpack(">II", body)
            data_offset = here + 8 + offset
            data_bytes = size - 8 - offset
        f.seek(here + size + (size & 1))  # chunks are word-aligned

    if channels <= 0 or rate < 1.0:  # <1 Hz would round to samplerate 0
        raise AiffFormatError("missing/invalid COMM chunk")
    comp_u = comp.upper()
    if comp_u not in (b"NONE", b"SOWT", b"FL32", b"ULAW", b"ALAW"):
        raise AiffFormatError(f"unsupported AIFF-C compression {comp!r}")
    little = comp_u == b"SOWT"
    container = 0
    if comp_u == b"FL32":
        subtype, bits = "FLOAT", 32
    elif comp_u in (b"ULAW", b"ALAW"):
        # G.711: COMM sampleSize names the decoded width (16); on disk
        # each sample is one code byte
        subtype, container = comp_u.decode(), 1
    else:
        subtype = {8: "PCM_8", 16: "PCM_16", 24: "PCM_24", 32: "PCM_32"}.get(bits)
        if subtype is None:
            raise AiffFormatError(f"unsupported sample size {bits}")
    if little and subtype != "PCM_16":
        raise AiffFormatError("sowt is only defined for 16-bit PCM")
    bpf = channels * (container or bits // 8)
    if data_offset is None:
        if frames > 0:
            # COMM promises audio but the file has no SSND (crash-truncated
            # before it, or metadata-only): without this, read() would seek
            # to offset 0 and decode the FORM/COMM header bytes as samples
            raise AiffFormatError("missing SSND chunk (frames > 0)")
        data_offset = 0
    elif data_offset is not None:
        # clamp against the PHYSICAL file size too (mirrors wavio's
        # _parse_header clamp): a crash-truncated file whose SSND size
        # overstates the payload would otherwise short-read and fail the
        # reshape in read() — or silently mis-report frames
        try:
            phys = os.fstat(f.fileno()).st_size - data_offset
        except (OSError, AttributeError):  # non-file objects (BytesIO)
            pos = f.tell()
            f.seek(0, 2)
            phys = f.tell() - data_offset
            f.seek(pos)
        # data_bytes < 0 (malformed offset past the chunk) means unknown:
        # fall back to the physical extent; an exact 0 is an EMPTY payload
        # and must stay 0, not swallow trailing chunks
        data_bytes = max(0, min(data_bytes, phys)) if data_bytes >= 0 else max(0, phys)
    if frames * bpf > data_bytes:
        frames = data_bytes // bpf  # tolerate truncated files like wavio
    return AiffInfo(
        samplerate=int(round(rate)), channels=channels, frames=frames,
        subtype=subtype, bits_per_sample=bits, data_offset=data_offset,
        data_bytes=data_bytes, little_endian=little,
        container_bytes=container,
    )


def info(path: str) -> AiffInfo:
    with open(path, "rb") as f:
        return _parse(f)


def _decode(raw: np.ndarray, inf: AiffInfo) -> np.ndarray:
    if inf.subtype in ("ULAW", "ALAW"):
        from . import g711

        fn = g711.ulaw_to_f32 if inf.subtype == "ULAW" else g711.alaw_to_f32
        return fn(raw.view(np.uint8))
    if inf.subtype == "PCM_8":          # AIFF 8-bit is SIGNED (unlike WAV)
        return raw.view(np.int8).astype(np.float32) / 128.0
    if inf.subtype == "PCM_16":
        dt = "<i2" if inf.little_endian else ">i2"
        return raw.view(dt).astype(np.float32) / 32768.0
    if inf.subtype == "PCM_24":         # big-endian 3-byte
        b = raw.reshape(-1, 3)
        vals = (
            (b[:, 0].astype(np.uint32) << 16)
            | (b[:, 1].astype(np.uint32) << 8)
            | b[:, 2].astype(np.uint32)
        ).astype(np.int32)
        vals = (vals << 8) >> 8
        return vals.astype(np.float32) / 8388608.0
    if inf.subtype == "PCM_32":
        return raw.view(">i4").astype(np.float32) / 2147483648.0
    if inf.subtype == "FLOAT":
        return raw.view(">f4").astype(np.float32)
    raise AiffFormatError(f"unsupported subtype {inf.subtype}")


def read(
    path: str,
    start: int = 0,
    frames: Optional[int] = None,
    always_2d: bool = False,
) -> Tuple[np.ndarray, int]:
    """Float32 samples, ``(frames,)`` mono / ``(frames, channels)`` otherwise,
    with the same EOF clamping as ``wavio.read``."""
    with open(path, "rb") as f:
        inf = _parse(f)
        bpf = inf.channels * inf.bytes_per_sample
        start = max(0, min(int(start), inf.frames))
        if frames is None:
            frames = inf.frames - start
        frames = max(0, min(int(frames), inf.frames - start))
        f.seek(inf.data_offset + start * bpf)
        raw = np.frombuffer(f.read(frames * bpf), dtype=np.uint8)
    data = _decode(raw, inf).reshape(-1, inf.channels)
    if inf.channels == 1 and not always_2d:
        data = data[:, 0]
    return data, inf.samplerate
