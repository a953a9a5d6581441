"""MPEG audio (MP3 / Layer I-II) read and test-vector write over the system
libraries, through ctypes (a copy of the JAX package's ``io/mp3.py``).

The reference reads MPEG audio through its decode stack (libsndfile >= 1.1
or audioread, voice_activity.py:37 ``sf.read``).  Here the system
**libmpg123** (decode) and **libmp3lame** (encode, used to write test
vectors) are bound directly with ctypes: no headers and no compile, and
``available()`` is False where the library does not load.

Decode details:

  * the handle forces ``MPG123_FORCE_FLOAT | MPG123_GAPLESS | MPG123_QUIET``
    and pins the output format after the first header, so a mid-stream
    format change errors instead of silently resampling;
  * ``mpg123_scan`` runs at first open: exact total sample count (with
    LAME/Xing gapless trims when the tag is present) and a frame index
    that makes ``mpg123_seek`` sample-accurate; post-seek samples match a
    continuous decode to <= 1 float ulp (the synthesis filterbank re-warms
    from MPG123_PREFRAMES frames);
  * the scan result (frame index + exact length) is cached per
    (realpath, size, mtime): the detect path probes with ``info()`` and
    then opens a second handle in the fused engine, and the review screen
    opens a fresh handle per spectrogram window; without the cache every
    one of those re-reads the whole file to rebuild the index.  Later
    handles import it with ``mpg123_set_index`` (which copies) and skip
    the scan; range reads are byte-identical either way, and a full
    straight-through decode differs only by the <= 1-ulp seek re-warm
    above (a scanned handle internally seeks back to frame 0);
  * the 64-bit-suffixed entry points (``mpg123_open_64`` ...) are
    preferred, falling back to the unsuffixed names on builds without the
    LFS alias layer, so the off_t ABI is unambiguous.

Encode (``write_mp3``) writes CBR frames plus the LAME info tag (rewritten
over the reserved first frame after flush) so a round-trip decodes to
exactly the original sample count.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from ctypes import (POINTER, byref, c_char_p, c_double, c_float, c_int,
                    c_int64, c_long, c_size_t, c_ubyte, c_void_p)
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

# enum mpg123_parms (mpg123.h, ABI-stable since 1.0)
_MPG123_ADD_FLAGS = 2
# enum mpg123_param_flags
_MPG123_QUIET = 0x20
_MPG123_GAPLESS = 0x40
_MPG123_FORCE_FLOAT = 0x400
# enum mpg123_enc_enum
_MPG123_ENC_FLOAT_32 = 0x200
# return codes
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11

# MPEG mode for libmp3lame
_LAME_MONO = 3


class _FrameInfo(ctypes.Structure):
    # struct mpg123_frameinfo — public and ABI-frozen; padded with headroom
    # since we allocate and the library writes (same stance as oggvorbis.py)
    _fields_ = [
        ("version", c_int),      # 0=MPEG1 1=MPEG2 2=MPEG2.5
        ("layer", c_int),        # 1..3
        ("rate", c_long),
        ("mode", c_int),
        ("mode_ext", c_int),
        ("framesize", c_int),
        ("flags", c_int),
        ("emphasis", c_int),
        ("bitrate", c_int),
        ("abr_rate", c_int),
        ("vbr", c_int),
        ("_pad", c_ubyte * 64),
    ]


_libs = None
_tried = False
_load_lock = threading.Lock()


def _load():
    global _libs, _tried
    if _tried:
        return _libs
    with _load_lock:
        # double-checked (see oggvorbis._load: an unlocked load once
        # published _tried before _libs and reported a decodable file
        # as 'library missing')
        if _tried:
            return _libs
        return _load_locked()


def _load_locked():
    global _libs, _tried
    if os.environ.get("SOFTSPOKEN_DISABLE_MP3"):
        _tried = True
        return None
    try:
        mpg = ctypes.CDLL("libmpg123.so.0")
    except OSError as e:
        log.info("libmpg123 unavailable (%s); MP3 support disabled", e)
        _tried = True
        return None
    lame = None
    try:
        lame = ctypes.CDLL("libmp3lame.so.0")
    except OSError as e:
        log.info("libmp3lame unavailable (%s); MP3 encode disabled", e)
    try:
        _bind(mpg, lame)
    except AttributeError as e:
        log.info("libmpg123 missing symbol (%s); MP3 support disabled", e)
        _tried = True
        return None
    mpg.mpg123_init()  # no-op on modern builds, required on old ones
    _libs = (mpg, lame)
    _tried = True  # publish only after _libs is fully built
    return _libs


def _bind(mpg, lame):
    def _pick64(base, argtypes, restype):
        # prefer the explicit-64-bit-off_t entry point; fall back to the
        # plain name on builds without the LFS alias layer (off_t is
        # 64-bit on exactly the platforms that omit the aliases), and
        # publish the chosen function under the canonical _64 attribute
        try:
            fn = getattr(mpg, base + "_64")
        except AttributeError:
            fn = getattr(mpg, base)
            setattr(mpg, base + "_64", fn)
        fn.argtypes = argtypes
        fn.restype = restype

    mpg.mpg123_init.restype = c_int
    mpg.mpg123_new.restype = c_void_p
    mpg.mpg123_new.argtypes = [c_char_p, POINTER(c_int)]
    mpg.mpg123_delete.argtypes = [c_void_p]
    mpg.mpg123_param.argtypes = [c_void_p, c_int, c_long, c_double]
    mpg.mpg123_param.restype = c_int
    _pick64("mpg123_open", [c_void_p, c_char_p], c_int)
    mpg.mpg123_close.argtypes = [c_void_p]
    mpg.mpg123_close.restype = c_int
    mpg.mpg123_getformat.argtypes = [
        c_void_p, POINTER(c_long), POINTER(c_int), POINTER(c_int)]
    mpg.mpg123_getformat.restype = c_int
    mpg.mpg123_format_none.argtypes = [c_void_p]
    mpg.mpg123_format_none.restype = c_int
    mpg.mpg123_format.argtypes = [c_void_p, c_long, c_int, c_int]
    mpg.mpg123_format.restype = c_int
    mpg.mpg123_scan.argtypes = [c_void_p]
    mpg.mpg123_scan.restype = c_int
    _pick64("mpg123_length", [c_void_p], c_int64)
    _pick64("mpg123_seek", [c_void_p, c_int64, c_int], c_int64)
    _pick64("mpg123_index",
            [c_void_p, POINTER(POINTER(c_int64)), POINTER(c_int64),
             POINTER(c_size_t)], c_int)
    _pick64("mpg123_set_index",
            [c_void_p, POINTER(c_int64), c_int64, c_size_t], c_int)
    mpg.mpg123_read.argtypes = [c_void_p, c_void_p, c_size_t,
                                POINTER(c_size_t)]
    mpg.mpg123_read.restype = c_int
    mpg.mpg123_info.argtypes = [c_void_p, c_void_p]
    mpg.mpg123_info.restype = c_int
    mpg.mpg123_strerror.argtypes = [c_void_p]
    mpg.mpg123_strerror.restype = c_char_p

    if lame is None:
        return
    lame.lame_init.restype = c_void_p
    lame.lame_init.argtypes = []
    for fn in ("lame_set_in_samplerate", "lame_set_out_samplerate",
               "lame_set_num_channels", "lame_set_brate",
               "lame_set_quality", "lame_set_bWriteVbrTag",
               "lame_set_mode"):
        getattr(lame, fn).argtypes = [c_void_p, c_int]
        getattr(lame, fn).restype = c_int
    lame.lame_init_params.argtypes = [c_void_p]
    lame.lame_init_params.restype = c_int
    lame.lame_encode_buffer_ieee_float.argtypes = [
        c_void_p, POINTER(c_float), POINTER(c_float), c_int, c_void_p, c_int]
    lame.lame_encode_buffer_ieee_float.restype = c_int
    lame.lame_encode_flush.argtypes = [c_void_p, c_void_p, c_int]
    lame.lame_encode_flush.restype = c_int
    lame.lame_get_lametag_frame.argtypes = [c_void_p, c_void_p, c_size_t]
    lame.lame_get_lametag_frame.restype = c_size_t
    lame.lame_close.argtypes = [c_void_p]
    lame.lame_close.restype = c_int


def available() -> bool:
    return _load() is not None


def encoder_available() -> bool:
    libs = _load()
    return libs is not None and libs[1] is not None


class Mp3FormatError(Exception):
    pass


@dataclass(frozen=True)
class _ScanCacheEntry:
    rate: int
    channels: int
    total: int
    offsets: np.ndarray  # int64 frame-start byte offsets (owned copy)
    step: int
    fill: int


_scan_cache: dict = {}
_scan_cache_lock = threading.Lock()
_SCAN_CACHE_MAX = 64


def _scan_cache_key(path: str):
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (os.path.realpath(path), st.st_size, st.st_mtime_ns)


# MPEG samplerate field is 2 bits; index 3 is reserved in every version
def _valid_frame_header(b: bytes) -> bool:
    if len(b) < 4 or b[0] != 0xFF or (b[1] & 0xE0) != 0xE0:
        return False
    if (b[1] >> 3) & 0x3 == 1:      # version: reserved
        return False
    if (b[1] >> 1) & 0x3 == 0:      # layer: reserved
        return False
    br = b[2] >> 4
    if br in (0, 15):               # free-format / invalid bitrate
        return False
    return (b[2] >> 2) & 0x3 != 3   # samplerate: reserved


def is_mp3(path: str) -> bool:
    """Cheap sniff: an ID3v2 tag, or a structurally valid MPEG frame header
    at byte 0.  Deliberately strict (free-format bitrate rejected) since
    this runs last in read_any's format-dispatch chain; a false positive
    still fails cleanly in ``info()``/``read()``.
    """
    try:
        with open(path, "rb") as f:
            head = f.read(4)
    except OSError:
        return False
    if head[:3] == b"ID3":
        return True
    return _valid_frame_header(head)


@dataclass(frozen=True)
class Mp3Info:
    samplerate: int
    channels: int
    frames: int
    subtype: str = "MPEG_LAYER_III"
    bits_per_sample: int = 0  # lossy — no PCM bit depth
    data_bytes: int = 0  # no PCM payload on disk; consumers fall back to
    #                      frames * bytes-per-frame (silencer stream gate)

    @property
    def duration(self) -> float:
        return self.frames / self.samplerate


_LAYER_ROMAN = {1: "I", 2: "II", 3: "III"}


class _Handle:
    """mpg123 handle RAII: new → params → open → scan → pinned float32."""

    def __init__(self, path: str):
        libs = _load()
        if libs is None:
            raise Mp3FormatError(
                "MP3 support needs the system libmpg123 (libmpg123.so.0), "
                "which was not found")
        self.m = libs[0]
        self.h = None
        self.open = False
        err = c_int(0)
        h = self.m.mpg123_new(None, byref(err))
        if not h:
            raise Mp3FormatError(f"mpg123_new failed (rc={err.value})")
        self.h = h
        try:
            self.m.mpg123_param(
                h, _MPG123_ADD_FLAGS,
                _MPG123_FORCE_FLOAT | _MPG123_GAPLESS | _MPG123_QUIET, 0.0)
            if self.m.mpg123_open_64(h, path.encode()) != _MPG123_OK:
                raise Mp3FormatError(
                    f"not a decodable MPEG audio file: {path} "
                    f"({self._err()})")
            self.open = True
            rate = c_long(0)
            ch = c_int(0)
            enc = c_int(0)
            if self.m.mpg123_getformat(
                    h, byref(rate), byref(ch), byref(enc)) != _MPG123_OK:
                raise Mp3FormatError(f"mpg123_getformat failed: {path}")
            if rate.value <= 0 or ch.value <= 0:
                raise Mp3FormatError(
                    f"invalid MPEG header: {ch.value}ch@{rate.value}: {path}")
            key = _scan_cache_key(path)
            with _scan_cache_lock:
                cached = _scan_cache.get(key) if key is not None else None
            self.scanned = False
            if (cached is not None and cached.rate == rate.value
                    and cached.channels == ch.value
                    and self._import_index(cached)):
                total = cached.total
            else:
                # exact length + a seek index; also validates the whole
                # stream has one consistent format (scan errors on
                # mid-stream changes)
                if self.m.mpg123_scan(h) != _MPG123_OK:
                    raise Mp3FormatError(f"mpg123_scan failed: {path} "
                                         f"({self._err()})")
                self.scanned = True
                total = int(self.m.mpg123_length_64(h))
            if total <= 0:
                raise Mp3FormatError(f"no decodable MPEG frames: {path}")
            self.rate, self.channels, self.total = rate.value, ch.value, total
            # pin: a later header disagreeing with the first errors out
            # instead of silently changing rate/channels mid-read
            self.m.mpg123_format_none(h)
            if self.m.mpg123_format(h, c_long(self.rate), self.channels,
                                    _MPG123_ENC_FLOAT_32) != _MPG123_OK:
                raise Mp3FormatError(f"mpg123_format failed: {path}")
            fi = _FrameInfo()
            self.subtype = "MPEG_LAYER_III"
            if self.m.mpg123_info(h, byref(fi)) == _MPG123_OK:
                layer = _LAYER_ROMAN.get(int(fi.layer))
                if layer:
                    self.subtype = f"MPEG_LAYER_{layer}"
            if self.scanned and key is not None:
                self._export_index(key)
        except Exception:
            self.close()
            raise

    def _err(self) -> str:
        try:
            msg = self.m.mpg123_strerror(self.h)
            return msg.decode("utf-8", "replace") if msg else "?"
        except Exception:  # noqa: BLE001 — diagnostics only
            return "?"

    def _import_index(self, cached: "_ScanCacheEntry") -> bool:
        """Adopt a previous scan's frame index (mpg123_set_index copies
        into the handle's own table); False falls back to a fresh scan."""
        offs = cached.offsets
        rc = self.m.mpg123_set_index_64(
            self.h, offs.ctypes.data_as(POINTER(c_int64)),
            c_int64(cached.step), c_size_t(cached.fill))
        return rc == _MPG123_OK

    def _export_index(self, key) -> None:
        """Publish this handle's post-scan frame index to the cache.

        Best-effort: a failure just means the next open re-scans.  The
        offsets live in the handle, so they are copied out before close.
        """
        po = POINTER(c_int64)()
        step = c_int64(0)
        fill = c_size_t(0)
        rc = self.m.mpg123_index_64(self.h, byref(po), byref(step),
                                    byref(fill))
        if rc != _MPG123_OK or not po or fill.value <= 0:
            return
        offsets = np.ctypeslib.as_array(po, shape=(fill.value,)).copy()
        entry = _ScanCacheEntry(rate=self.rate, channels=self.channels,
                                total=self.total, offsets=offsets,
                                step=int(step.value), fill=int(fill.value))
        with _scan_cache_lock:
            if len(_scan_cache) >= _SCAN_CACHE_MAX and key not in _scan_cache:
                # drop the oldest insertion; long detect runs touch files
                # once each, so any bounded policy works here
                _scan_cache.pop(next(iter(_scan_cache)))
            _scan_cache[key] = entry

    def info(self, path: str = "") -> Mp3Info:
        return Mp3Info(samplerate=self.rate, channels=self.channels,
                       frames=self.total, subtype=self.subtype)

    def seek(self, frame: int) -> None:
        pos = int(self.m.mpg123_seek_64(self.h, c_int64(frame), 0))
        if pos != frame:
            raise Mp3FormatError(f"mpg123_seek({frame}) -> {pos} "
                                 f"({self._err()})")

    def read_into(self, out: np.ndarray) -> int:
        """Fill the float32 (n, ch) array; returns frames delivered."""
        done = c_size_t(0)
        got = 0
        want_bytes = out.nbytes
        base = out.ctypes.data
        while got * 4 < want_bytes:
            rc = self.m.mpg123_read(
                self.h, base + got * 4, want_bytes - got * 4, byref(done))
            got += done.value // 4
            if rc == _MPG123_DONE:
                break
            if rc == _MPG123_NEW_FORMAT:
                # pinned format: this means a genuinely different header
                raise Mp3FormatError("mid-stream format change unsupported")
            if rc != _MPG123_OK:
                raise Mp3FormatError(f"mpg123_read error {rc} ({self._err()})")
        return got // self.channels

    def close(self):
        if self.h is not None:
            if self.open:
                self.m.mpg123_close(self.h)
                self.open = False
            self.m.mpg123_delete(self.h)
            self.h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def info(path: str) -> Mp3Info:
    with _Handle(path) as h:
        return h.info(path)


def read(
    path: str, start: int = 0, frames: Optional[int] = None,
    always_2d: bool = False,
) -> Tuple[np.ndarray, int]:
    """Float32 samples [start, start+frames) at the native rate.

    Same contract as wavio.read/flac.read/oggvorbis.read: mono returns 1-D
    unless ``always_2d``; reads are clamped at EOF.  Range reads match a
    continuous decode to <= 1 float ulp (see module docstring).
    """
    with _Handle(path) as h:
        ch, total = h.channels, h.total
        start = max(0, min(int(start), total))
        want = total - start if frames is None else max(
            0, min(int(frames), total - start))
        out = np.empty((want, ch), np.float32)
        if want:
            if start > 0:
                h.seek(start)
            got = h.read_into(out)
            if got < want:
                out = out[:got]
        if ch == 1 and not always_2d:
            out = out[:, 0]
        return np.ascontiguousarray(out), h.rate


class SequentialMonoReader:
    """Mono float32 range reads over one persistent handle.

    The chunked engines read almost-sequential overlapping ranges; a
    per-range ``read()`` would re-open AND re-scan the whole file every
    chunk (O(n²) IO over a long recording).  One handle keeps the scan
    index, so each range is a cheap indexed seek + forward decode.
    """

    def __init__(self, path: str):
        self._h = _Handle(path)
        self.info = self._h.info(path)

    def read(self, start: int, frames: int) -> np.ndarray:
        total = self.info.frames
        start = max(0, min(int(start), total))
        want = max(0, min(int(frames), total - start))
        out = np.empty((want, self._h.channels), np.float32)
        if want:
            self._h.seek(start)
            got = self._h.read_into(out)
            if got < want:
                out = out[:got]
        if self._h.channels == 1:
            return out[:, 0]
        return out.mean(axis=1, dtype=np.float64).astype(np.float32)

    def close(self):
        self._h.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_mp3(path: str, data: np.ndarray, samplerate: int,
              bitrate_kbps: int = 96) -> None:
    """Encode float PCM ([-1,1], (n,) or (n,ch)) to a CBR MP3 file.

    Exists to synthesize test vectors (the app writes WAV, like
    the reference).  Writes the LAME info tag over the reserved first
    frame so gapless decoders recover the exact original sample count.
    """
    libs = _load()
    if libs is None or libs[1] is None:
        raise Mp3FormatError("libmp3lame not available for encoding")
    lame = libs[1]

    x = np.asarray(data, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    n, ch = x.shape
    if ch not in (1, 2):
        raise Mp3FormatError(f"MP3 encode supports 1-2 channels, got {ch}")
    if samplerate not in (8000, 11025, 12000, 16000, 22050, 24000,
                          32000, 44100, 48000):
        # lame would silently ROUND to the nearest MPEG rate — a test
        # vector must decode at exactly the rate it was requested at
        raise Mp3FormatError(f"not an MPEG sample rate: {samplerate}")

    g = lame.lame_init()
    if not g:
        raise Mp3FormatError("lame_init failed")
    ok = False
    # open the output FIRST so a bad path fails before encoding starts
    f = open(path, "wb")
    try:
        lame.lame_set_in_samplerate(g, samplerate)
        lame.lame_set_out_samplerate(g, samplerate)
        lame.lame_set_num_channels(g, ch)
        if ch == 1:
            lame.lame_set_mode(g, _LAME_MONO)
        lame.lame_set_brate(g, int(bitrate_kbps))
        lame.lame_set_quality(g, 2)
        lame.lame_set_bWriteVbrTag(g, 1)  # reserves frame 0 for the tag
        if lame.lame_init_params(g) < 0:
            raise Mp3FormatError(
                f"lame_init_params rejected {ch}ch@{samplerate} "
                f"@{bitrate_kbps}kbps (MPEG rates only: 8/11.025/12/16/"
                f"22.05/24/32/44.1/48 kHz)")
        left = np.ascontiguousarray(x[:, 0])
        right = np.ascontiguousarray(x[:, 1]) if ch == 2 else left
        buf = np.empty(n + n // 2 + 7200, np.uint8)  # lame's documented bound
        m = lame.lame_encode_buffer_ieee_float(
            g, left.ctypes.data_as(POINTER(c_float)),
            right.ctypes.data_as(POINTER(c_float)),
            n, buf.ctypes.data, buf.nbytes)
        if m < 0:
            raise Mp3FormatError(f"lame_encode_buffer rc={m}")
        f.write(buf[:m].tobytes())
        m = lame.lame_encode_flush(g, buf.ctypes.data, buf.nbytes)
        if m < 0:
            raise Mp3FormatError(f"lame_encode_flush rc={m}")
        f.write(buf[:m].tobytes())
        # rewrite the reserved first frame with the real gapless tag
        tag = int(lame.lame_get_lametag_frame(g, buf.ctypes.data, buf.nbytes))
        if 0 < tag <= buf.nbytes:
            f.flush()
            f.seek(0)
            f.write(buf[:tag].tobytes())
        ok = True
    finally:
        f.close()
        lame.lame_close(g)
        if not ok:
            # no 0-byte/truncated .mp3 left behind for a failed encode
            try:
                os.remove(path)
            except OSError:
                pass
