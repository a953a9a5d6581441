"""Minimal RIFF/WAVE reader for the detector's streaming path (numpy only).

Reads little-endian integer PCM (8/16/24/32-bit) and IEEE float (32/64-bit)
WAV and RF64 files, plain or WAVE_FORMAT_EXTENSIBLE:

  * ``probe`` — header-only ``WavInfo``
  * ``RawReader`` — persistent handle with frame-range raw reads and
    readahead hints, for the int16 wire
  * ``read_mono_f32`` — a frame range decoded to float32 and downmixed
    (channel mean), for the float32 wire

Integer PCM is scaled by 1/2**(bits-1) into [-1, 1) (libsndfile's
convention, as the reference's soundfile/librosa reads did).  Other
containers and codecs (FLAC, MP3, Opus, AIFF, ADPCM, G.711, big-endian RIFX)
raise ``NotImplementedError`` naming the format (``sniff_format`` reads
their magic): their readers are a later slice of the port.  Any other file
is a malformed WAV (``WavFormatError``).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import BinaryIO, Optional

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE

_SUBTYPES = {
    (WAVE_FORMAT_PCM, 1): "PCM_U8", (WAVE_FORMAT_PCM, 2): "PCM_16",
    (WAVE_FORMAT_PCM, 3): "PCM_24", (WAVE_FORMAT_PCM, 4): "PCM_32",
    (WAVE_FORMAT_IEEE_FLOAT, 4): "FLOAT", (WAVE_FORMAT_IEEE_FLOAT, 8): "DOUBLE",
}
_LATER = ("this reader is a later slice of the PyTorch port; "
          "convert the file to PCM or float WAV")


class WavFormatError(ValueError):
    """A malformed RIFF/WAVE file."""


@dataclass(frozen=True)
class WavInfo:
    samplerate: int
    channels: int
    frames: int
    subtype: str
    bits_per_sample: int
    data_offset: int
    data_bytes: int
    container_bytes: int

    @property
    def duration(self) -> float:
        return self.frames / float(self.samplerate)


def sniff_format(head: bytes) -> Optional[str]:
    """The name of a non-WAV audio format from a file's first bytes, or
    None.  Those formats' readers are a later slice of the port."""
    if head[:4] == b"fLaC":
        return "FLAC"
    if head[:4] == b"OggS":
        return "Ogg Opus" if b"OpusHead" in head else "Ogg Vorbis"
    if head[:4] == b"FORM" and head[8:12] in (b"AIFF", b"AIFC"):
        return "AIFF"
    if head[:16] == b"riff\x2e\x91\xcf\x11\xa5\xd6\x28\xdb\x04\xc1\x00\x00":
        return "Sony Wave64"
    if head[:4] == b"caff":
        return "CAF"
    if head[:4] == b".snd":
        return "Sun AU"
    if head[:8] == b"NIST_1A\n":
        return "NIST SPHERE"
    if head[:3] == b"ID3" or (len(head) > 1 and head[0] == 0xFF and head[1] & 0xE0 == 0xE0):
        return "MP3"
    return None


def _parse_header(f: BinaryIO) -> WavInfo:
    riff = f.read(12)
    if len(riff) < 12 or riff[8:12] != b"WAVE" or riff[:4] not in (b"RIFF", b"RF64", b"RIFX"):
        fmt = sniff_format(riff + f.read(52))
        if fmt is not None:
            raise NotImplementedError(f"{fmt} file: {_LATER}")
        raise WavFormatError("not a RIFF/WAVE file")
    if riff[:4] == b"RIFX":
        raise NotImplementedError(f"big-endian RIFX WAV: {_LATER}")
    rf64_size = None
    fmt = None
    data_offset = data_bytes = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, csize = struct.unpack("<4sI", hdr)
        if cid in (b"ds64", b"fmt "):
            body = f.read(csize + (csize & 1))
            if cid == b"ds64":
                if len(body) < 16:
                    raise WavFormatError("truncated ds64 chunk")
                rf64_size = struct.unpack("<Q", body[8:16])[0]
                continue
            if len(body) < 16:
                raise WavFormatError("truncated fmt chunk")
            tag, channels, sr, _br, align, bits = struct.unpack("<HHIIHH", body[:16])
            if tag == WAVE_FORMAT_EXTENSIBLE:
                if len(body) < 28:
                    raise WavFormatError("truncated WAVE_FORMAT_EXTENSIBLE fmt chunk")
                tag = struct.unpack("<I", body[24:28])[0]
            fmt = (tag, channels, sr, align, bits)
        elif cid == b"data" and data_offset is None:
            data_offset = f.tell()
            data_bytes = rf64_size if (csize == 0xFFFFFFFF and rf64_size) else csize
            f.seek(data_bytes + (data_bytes & 1), os.SEEK_CUR)
        else:
            f.seek(csize + (csize & 1), os.SEEK_CUR)
    if fmt is None or data_offset is None:
        raise WavFormatError("missing fmt or data chunk")
    tag, channels, sr, align, bits = fmt
    if channels <= 0 or sr <= 0 or align <= 0 or align % channels:
        raise WavFormatError(f"invalid fmt chunk: channels={channels} "
                             f"samplerate={sr} block_align={align}")
    container = align // channels
    subtype = _SUBTYPES.get((tag, container))
    if subtype is None:
        raise NotImplementedError(
            f"WAV format tag 0x{tag:04x} with {container}-byte samples: {_LATER}")
    try:  # a crashed recorder's header may overstate the payload
        data_bytes = min(data_bytes, os.fstat(f.fileno()).st_size - data_offset)
    except (OSError, AttributeError):
        pass
    frames = max(0, data_bytes) // align
    return WavInfo(sr, channels, frames, subtype, bits, data_offset,
                   frames * align, container)


def probe(path: str) -> WavInfo:
    """Header-only probe (no sample data read)."""
    with open(path, "rb") as f:
        return _parse_header(f)


def decode(raw: np.ndarray, subtype: str) -> np.ndarray:
    """Raw little-endian sample bytes → float32 (interleaved)."""
    if subtype == "PCM_U8":
        return (raw.astype(np.float32) - 128.0) / 128.0
    if subtype == "PCM_16":
        return raw.view("<i2").astype(np.float32) / 32768.0
    if subtype == "PCM_24":
        b = raw.reshape(-1, 3).astype(np.int32)
        v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        v = np.where(v >= (1 << 23), v - (1 << 24), v)
        return v.astype(np.float32) / 8388608.0
    if subtype == "PCM_32":
        return raw.view("<i4").astype(np.float32) / 2147483648.0
    if subtype == "FLOAT":
        return raw.view("<f4").astype(np.float32)
    if subtype == "DOUBLE":
        return raw.view("<f8").astype(np.float32)
    raise NotImplementedError(f"subtype {subtype}: {_LATER}")


class RawReader:
    """Persistent frame-range reader of raw sample bytes.

    One handle with POSIX_FADV_SEQUENTIAL, and ``will_need`` hints for the
    next range, so the kernel prefetches while the card computes.
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            self.info = _parse_header(self._f)
        except BaseException:
            self._f.close()
            raise
        self._bpf = self.info.channels * self.info.container_bytes
        try:
            os.posix_fadvise(self._f.fileno(), 0, 0, os.POSIX_FADV_SEQUENTIAL)
        except (AttributeError, OSError):
            pass

    def _clamp(self, start: int, frames: int):
        n = self.info.frames
        start = max(0, min(int(start), n))
        return start, max(0, min(int(frames), n - start))

    def read_raw(self, start: int, frames: int) -> np.ndarray:
        """Raw sample bytes (uint8) for a frame range, clamped at EOF."""
        start, frames = self._clamp(start, frames)
        self._f.seek(self.info.data_offset + start * self._bpf)
        return np.frombuffer(self._f.read(frames * self._bpf), dtype=np.uint8)

    def read_mono_f32(self, start: int, frames: int) -> np.ndarray:
        """Float32 mono samples for a frame range (channel mean)."""
        data = decode(self.read_raw(start, frames), self.info.subtype)
        ch = self.info.channels
        if ch == 1:
            return data
        return data.reshape(-1, ch).mean(axis=1, dtype=np.float64).astype(np.float32)

    def will_need(self, start: int, frames: int) -> None:
        """Readahead hint for an upcoming range (no-op where unsupported)."""
        start, frames = self._clamp(start, frames)
        try:
            os.posix_fadvise(self._f.fileno(), self.info.data_offset + start * self._bpf,
                             frames * self._bpf, os.POSIX_FADV_WILLNEED)
        except (AttributeError, OSError):
            pass

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "RawReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_mono_f32(path: str, start: int = 0, frames: Optional[int] = None) -> np.ndarray:
    """Float32 mono samples of a frame range (whole file by default)."""
    with RawReader(path) as r:
        return r.read_mono_f32(start, r.info.frames if frames is None else frames)


def write(path: str, data: np.ndarray, samplerate: int, subtype: str = "PCM_16") -> None:
    """Write float samples ((frames,) or (frames, channels)) as PCM_16 or
    FLOAT WAV — enough for the port's tests and its smoke run."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    channels = data.shape[1]
    if subtype == "PCM_16":
        payload = np.clip(np.rint(data * 32768.0), -32768, 32767).astype("<i2").tobytes()
        tag, bits = WAVE_FORMAT_PCM, 16
    elif subtype == "FLOAT":
        payload = data.astype("<f4").tobytes()
        tag, bits = WAVE_FORMAT_IEEE_FLOAT, 32
    else:
        raise NotImplementedError(f"writing {subtype}: {_LATER}")
    align = channels * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(payload) + (len(payload) & 1)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, tag, channels, samplerate,
                                      samplerate * align, align, bits))
        f.write(b"data" + struct.pack("<I", len(payload)) + payload)
        if len(payload) & 1:
            f.write(b"\x00")
