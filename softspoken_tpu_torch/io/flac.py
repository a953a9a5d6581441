"""FLAC reading via the native decoder (csrc/ssflac.cpp, ctypes).

A copy of the JAX package's ``io/flac.py``; the decoder is the port's byte
copy of ``csrc/ssflac.cpp``, built with g++ by ``ops/_build.build_host``.
The reference's ``sf.read`` decodes FLAC through libsndfile
(voice_activity.py:37); field recorders and archives write FLAC.  The API
mirrors ``wavio``: ``info`` / ``read`` / ``FlacReader`` with frame-range
random access (SEEKTABLE-assisted), and ``SequentialMonoReader`` for the
chunked pipelines.

Float conversion matches libsndfile: integer samples scaled by
1/2**(bits-1) into [-1, 1).
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .native import NATIVE_CALLS, load_host_lib

# counted lengths of unknown-length FLACs, keyed (abspath, size, mtime_ns)
_UNKNOWN_LEN_CACHE: dict = {}

log = logging.getLogger(__name__)

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


class FlacError(ValueError):
    pass


@dataclass(frozen=True)
class FlacInfo:
    samplerate: int
    channels: int
    frames: int
    subtype: str
    bits_per_sample: int
    # parity with wavio.WavInfo so probe callers can duck-type
    data_offset: int = 0
    data_bytes: int = 0

    @property
    def duration(self) -> float:
        return self.frames / float(self.samplerate)


def is_flac(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(4) == b"fLaC"
    except OSError:
        return False


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        lib = load_host_lib("ssflac")
        if lib is None:
            return None
        lib.ssflac_open.restype = ctypes.c_void_p
        lib.ssflac_open.argtypes = [ctypes.c_char_p]
        lib.ssflac_info.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.ssflac_read_i32.restype = ctypes.c_longlong
        lib.ssflac_read_i32.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong,
        ]
        lib.ssflac_seek.restype = ctypes.c_int
        lib.ssflac_seek.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        lib.ssflac_error.restype = ctypes.c_char_p
        lib.ssflac_error.argtypes = [ctypes.c_void_p]
        lib.ssflac_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def flac_available() -> bool:
    return _get_lib() is not None


class FlacReader:
    """Handle-based streaming reader with frame-range random access."""

    def __init__(self, path: str):
        lib = _get_lib()
        if lib is None:
            raise FlacError("native FLAC decoder unavailable (no g++?)")
        self._lib = lib
        self._h = lib.ssflac_open(path.encode())
        if not self._h:
            raise FlacError(f"not a decodable FLAC file: {path}")
        total = ctypes.c_longlong()
        sr = ctypes.c_int()
        ch = ctypes.c_int()
        bits = ctypes.c_int()
        lib.ssflac_info(self._h, ctypes.byref(total), ctypes.byref(sr),
                        ctypes.byref(ch), ctypes.byref(bits))
        if sr.value <= 0 or ch.value <= 0 or bits.value <= 0:
            # corrupted STREAMINFO (fuzz): zero fields would divide later
            lib.ssflac_close(self._h)
            self._h = None
            raise FlacError(
                f"invalid STREAMINFO: sr={sr.value} ch={ch.value} "
                f"bits={bits.value}: {path}")
        if total.value == 0:
            # STREAMINFO total_samples == 0 means UNKNOWN length per the
            # FLAC spec (streaming encoders emit it); treating it as a
            # real zero silently decoded such files as empty.
            # One bounded counting pass establishes the true length, then
            # the handle is reopened at frame 0.  The count is cached per
            # (path, size, mtime): probe()/info() sit on hot UI paths
            # (every spectrogram render), and re-decoding a multi-minute
            # file per zoom step is pure waste.
            try:
                st = os.stat(path)
                cache_key = (os.path.abspath(path), st.st_size,
                             st.st_mtime_ns)
            except OSError:
                cache_key = None
            cached = _UNKNOWN_LEN_CACHE.get(cache_key) if cache_key else None
            if cached is not None:
                total.value = cached
        if total.value == 0:
            n = 0
            scratch = np.empty(self._READ_BLOCK * ch.value, np.int32)
            ptr = scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            while True:
                got = lib.ssflac_read_i32(self._h, ptr, self._READ_BLOCK)
                if got < 0:
                    msg = lib.ssflac_error(self._h).decode() or "decode error"
                    lib.ssflac_close(self._h)
                    self._h = None
                    raise FlacError(f"{msg}: {path}")
                if got == 0:
                    break
                n += int(got)
            lib.ssflac_close(self._h)
            self._h = lib.ssflac_open(path.encode())
            if not self._h:
                raise FlacError(f"not a decodable FLAC file: {path}")
            total.value = n
            if cache_key:
                if len(_UNKNOWN_LEN_CACHE) > 256:
                    _UNKNOWN_LEN_CACHE.clear()
                _UNKNOWN_LEN_CACHE[cache_key] = n
        self.info = FlacInfo(
            samplerate=sr.value, channels=ch.value, frames=total.value,
            subtype=f"FLAC_{bits.value}", bits_per_sample=bits.value,
        )
        self._pos = 0
        self._eof_pin = False

    def seek(self, frame: int) -> None:
        frame = max(0, min(int(frame), self.info.frames))
        if frame == self._pos:
            return
        if frame >= self.info.frames:
            # EOF seek: the native seek looks for a block CONTAINING the
            # target, which cannot exist at exactly total_samples — it
            # would fail where the contract ('reads clamp at EOF') promises
            # an empty read
            self._pos = self.info.frames
            self._eof_pin = True
            return
        self._eof_pin = False
        if self._lib.ssflac_seek(self._h, frame) != 0:
            raise FlacError(f"seek to frame {frame} failed: "
                            f"{self._lib.ssflac_error(self._h).decode()}")
        self._pos = frame

    # per-step allocation bound: a corrupted STREAMINFO total_samples (36-bit
    # field, up to 64G frames) must not size one giant np.empty — grow with
    # the data that actually decodes instead (found by tests/test_codec_fuzz)
    _READ_BLOCK = 1 << 22

    def read_i32(self, frames: int) -> np.ndarray:
        """Next ``frames`` interleaved int32 samples at native bit depth;
        shorter at EOF."""
        ch = self.info.channels
        if getattr(self, "_eof_pin", False):
            # seek() pinned the logical position at EOF without moving the
            # native handle; decoding from its real position would return
            # mid-file samples labeled as EOF data
            return np.zeros((0, ch), np.int32)
        parts = []
        remaining = int(frames)
        while remaining > 0:
            take = min(remaining, self._READ_BLOCK)
            out = np.empty(take * ch, np.int32)
            got = self._lib.ssflac_read_i32(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                take)
            if got < 0:
                raise FlacError(
                    self._lib.ssflac_error(self._h).decode() or "decode error")
            NATIVE_CALLS["flac_read_i32"] += 1
            self._pos += int(got)
            parts.append(out[: int(got) * ch].reshape(-1, ch))
            remaining -= int(got)
            if got < take:
                # short read: EOF — or salvaged samples before a mid-stream
                # decode error (the native layer delivers data first and
                # reports the error on the NEXT call).  Probe once so
                # corruption raises instead of silently truncating the
                # audio.
                probe = self._lib.ssflac_read_i32(
                    self._h, out.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_int32)), 1)
                if probe < 0:
                    raise FlacError(
                        self._lib.ssflac_error(self._h).decode()
                        or "decode error")
                if probe > 0:  # paranoia: never drop a decoded frame
                    self._pos += int(probe)
                    parts.append(out[: int(probe) * ch].reshape(-1, ch).copy())
                    remaining -= int(probe)
                    continue
                break
        if len(parts) == 1:
            return parts[0]
        return (np.concatenate(parts)
                if parts else np.zeros((0, ch), np.int32))

    def read_f32(self, start: int = 0, frames: Optional[int] = None,
                 always_2d: bool = False) -> np.ndarray:
        inf = self.info
        start = max(0, min(int(start), inf.frames))
        if frames is None:
            frames = inf.frames - start
        frames = max(0, min(int(frames), inf.frames - start))
        if frames == 0:
            # empty read at/past EOF: match wavio.read (a seek to the very
            # end would decode the whole stream just to error out)
            data = np.zeros((0, inf.channels), np.float32)
            return data if (inf.channels > 1 or always_2d) else data[:, 0]
        self.seek(start)
        raw = self.read_i32(frames)
        scale = np.float32(1.0 / (1 << (inf.bits_per_sample - 1)))
        data = raw.astype(np.float32) * scale
        if inf.channels == 1 and not always_2d:
            return data[:, 0]
        return data

    def close(self) -> None:
        if self._h:
            self._lib.ssflac_close(self._h)
            self._h = None

    def __enter__(self) -> "FlacReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


def info(path: str) -> FlacInfo:
    with FlacReader(path) as r:
        return r.info


def read(path: str, start: int = 0, frames: Optional[int] = None,
         always_2d: bool = False) -> Tuple[np.ndarray, int]:
    """Read float32 samples (API parity with ``wavio.read``)."""
    with FlacReader(path) as r:
        return r.read_f32(start, frames, always_2d), r.info.samplerate


class SequentialMonoReader:
    """Mono float32 range reads tuned for the streaming pipelines.

    FLAC has no random-access index by default — a backward seek without a
    SEEKTABLE re-decodes from the previous seekpoint (or the stream start).
    The chunked engines read almost-sequential ranges that overlap by a
    resampler filter length, so this wrapper keeps a rolling buffer and
    serves overlaps from memory; the decoder itself only ever moves forward.
    """

    def __init__(self, path: str, dtype: str = "f32",
                 truncate_to_i16: bool = False):
        """dtype='i16' serves raw int16 (mono, ≤16-bit streams only): the
        fused engine then uploads HALF the bytes of f32, which matters on a
        link-bound e2e path.  A b-bit sample shifted
        left by 16−b then divided by 32768 on device equals the f32 path's
        v/2^(b−1) exactly, so the two modes are bit-identical downstream.

        ``truncate_to_i16=True`` additionally admits mono streams with
        bits_per_sample > 16, keeping each sample's TOP 16 bits (arithmetic
        right shift).  That is lossy (≤1 int16 LSB ≈ 3e-5 full scale), so
        the fused engine enables it only when the wire is the 8-bit mu-law
        compander, whose quantization step (~1.7e-4 at its finest) dwarfs
        the truncation — same evidence envelope as ops/mulaw.py."""
        self.reader = FlacReader(path)
        self.info = self.reader.info
        if dtype == "i16" and (
            self.info.channels != 1
            or (self.info.bits_per_sample > 16 and not truncate_to_i16)
        ):
            raise ValueError(
                "i16 streaming needs a mono stream with bits_per_sample<=16 "
                "(or truncate_to_i16=True) "
                f"(got {self.info.channels} ch, {self.info.bits_per_sample} bit)")
        self._np_dtype = np.int16 if dtype == "i16" else np.float32
        self._shift = 16 - self.info.bits_per_sample
        self._buf = np.zeros(0, self._np_dtype)
        self._buf_start = 0

    def _decode_forward(self, frames: int) -> np.ndarray:
        raw = self.reader.read_i32(frames)
        if self._np_dtype == np.int16:
            if self._shift < 0:  # >16-bit stream: keep the top 16 bits
                return (raw[:, 0] >> (-self._shift)).astype(np.int16)
            return (raw[:, 0] << self._shift).astype(np.int16)
        scale = np.float32(1.0 / (1 << (self.info.bits_per_sample - 1)))
        data = raw.astype(np.float32) * scale
        return data.mean(axis=1) if self.info.channels > 1 else data[:, 0]

    def read(self, start: int, frames: int) -> np.ndarray:
        inf = self.info
        start = max(0, min(int(start), inf.frames))
        frames = max(0, min(int(frames), inf.frames - start))
        end = start + frames
        buf_end = self._buf_start + len(self._buf)
        if start < self._buf_start:             # true backward jump
            self.reader.seek(start)
            self._buf = self._decode_forward(frames)
            self._buf_start = start
        else:
            if start > buf_end:                 # forward gap: skip-decode
                self.reader.seek(start)
                self._buf = np.zeros(0, self._np_dtype)
                self._buf_start = start
                buf_end = start
            if end > buf_end:                   # extend forward
                more = self._decode_forward(end - buf_end)
                self._buf = np.concatenate([self._buf, more])
        out = self._buf[start - self._buf_start : start - self._buf_start + frames]
        # trim the consumed prefix, keep one requested span as overlap context
        keep_from = max(0, start - self._buf_start)
        self._buf = self._buf[keep_from:]
        self._buf_start += keep_from
        return out.copy()

    def close(self) -> None:
        self.reader.close()

    def __enter__(self) -> "SequentialMonoReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
