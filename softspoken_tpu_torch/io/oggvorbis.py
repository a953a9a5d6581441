"""Ogg/Vorbis read and test-vector write over the system libvorbis, through
ctypes (a copy of the JAX package's ``io/oggvorbis.py``).

The reference reads Ogg incidentally through libsndfile
(voice_activity.py:37 ``sf.read``).  Here the codec libraries
(libvorbisfile/libvorbisenc/libogg) are bound directly with ctypes: no
headers and no compile, and ``available()`` is False where they do not
load.

Decode uses the high-level vorbisfile API (ov_fopen/ov_read_float/
ov_pcm_seek): sample-accurate random access, float32 output at full codec
precision.  Encode (``write_vorbis``) writes test vectors; the app itself
always writes WAV like the reference.

ABI notes: OggVorbis_File and the encoder's dsp/block/stream states are
treated as opaque caller-allocated buffers, overallocated ~2-4x their real
sizes; only vorbis_info / ogg_packet / ogg_page (public, ABI-frozen since
libvorbis 1.0) are declared field by field.
"""

from __future__ import annotations

import ctypes
import logging
import os
from ctypes import (POINTER, byref, c_char_p, c_double, c_float, c_int,
                    c_int64, c_long, c_ubyte, c_void_p)
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)


class _VorbisInfo(ctypes.Structure):
    _fields_ = [
        ("version", c_int),
        ("channels", c_int),
        ("rate", c_long),
        ("bitrate_upper", c_long),
        ("bitrate_nominal", c_long),
        ("bitrate_lower", c_long),
        ("bitrate_window", c_long),
        ("codec_setup", c_void_p),
        ("_pad", c_ubyte * 64),  # headroom: we allocate, the lib writes
    ]


class _VorbisComment(ctypes.Structure):
    _fields_ = [
        ("user_comments", c_void_p),
        ("comment_lengths", c_void_p),
        ("comments", c_int),
        ("vendor", c_char_p),
        ("_pad", c_ubyte * 64),
    ]


class _OggPacket(ctypes.Structure):
    _fields_ = [
        ("packet", c_void_p),
        ("bytes", c_long),
        ("b_o_s", c_long),
        ("e_o_s", c_long),
        ("granulepos", c_int64),
        ("packetno", c_int64),
        ("_pad", c_ubyte * 32),
    ]


class _OggPage(ctypes.Structure):
    _fields_ = [
        ("header", c_void_p),
        ("header_len", c_long),
        ("body", c_void_p),
        ("body_len", c_long),
        ("_pad", c_ubyte * 32),
    ]


# opaque caller-allocated state, overallocated vs the real ABI sizes
_OV_FILE_BYTES = 4096        # OggVorbis_File ~ 944
_DSP_BYTES = 1024            # vorbis_dsp_state ~ 160
_BLOCK_BYTES = 1024          # vorbis_block ~ 192
_STREAM_BYTES = 2048         # ogg_stream_state ~ 408

_libs = None
_tried = False
_load_lock = __import__("threading").Lock()


def _load():
    global _libs, _tried
    if _tried:
        return _libs
    with _load_lock:
        # double-checked: without the lock a concurrent caller observed
        # _tried=True while _libs was still mid-load and wrongly reported
        # 'libvorbis not found' for a decodable file
        if _tried:
            return _libs
        return _load_locked()


def _load_locked():
    global _libs, _tried
    if os.environ.get("SOFTSPOKEN_DISABLE_VORBIS"):
        _tried = True
        return None
    try:
        mode = ctypes.RTLD_GLOBAL
        ogg = ctypes.CDLL("libogg.so.0", mode=mode)
        vorbis = ctypes.CDLL("libvorbis.so.0", mode=mode)
        vfile = ctypes.CDLL("libvorbisfile.so.3", mode=mode)
        venc = ctypes.CDLL("libvorbisenc.so.2", mode=mode)
    except OSError as e:
        log.info("libvorbis unavailable (%s); OGG support disabled", e)
        _tried = True
        return None
    try:
        _bind(ogg, vorbis, vfile, venc)
    except AttributeError as e:
        # library present but a bound symbol missing (stripped / ancient
        # build): degrade to available()==False like a missing library,
        # and don't re-dlopen on every probe
        log.info("libvorbis missing symbol (%s); OGG support disabled", e)
        _tried = True
        return None
    _libs = (ogg, vorbis, vfile, venc)
    _tried = True  # publish only after _libs is fully built
    return _libs


def _bind(ogg, vorbis, vfile, venc):
    vfile.ov_fopen.argtypes = [c_char_p, c_void_p]
    vfile.ov_fopen.restype = c_int
    vfile.ov_info.argtypes = [c_void_p, c_int]
    vfile.ov_info.restype = POINTER(_VorbisInfo)
    vfile.ov_pcm_total.argtypes = [c_void_p, c_int]
    vfile.ov_pcm_total.restype = c_int64
    vfile.ov_pcm_tell.argtypes = [c_void_p]
    vfile.ov_pcm_tell.restype = c_int64
    vfile.ov_pcm_seek.argtypes = [c_void_p, c_int64]
    vfile.ov_pcm_seek.restype = c_int
    vfile.ov_read_float.argtypes = [
        c_void_p, POINTER(POINTER(POINTER(c_float))), c_int, POINTER(c_int)]
    vfile.ov_read_float.restype = c_long
    vfile.ov_clear.argtypes = [c_void_p]
    vfile.ov_clear.restype = c_int

    vorbis.vorbis_info_init.argtypes = [c_void_p]
    vorbis.vorbis_comment_init.argtypes = [c_void_p]
    vorbis.vorbis_analysis_init.argtypes = [c_void_p, c_void_p]
    vorbis.vorbis_analysis_init.restype = c_int
    vorbis.vorbis_block_init.argtypes = [c_void_p, c_void_p]
    vorbis.vorbis_block_init.restype = c_int
    vorbis.vorbis_analysis_headerout.argtypes = [
        c_void_p, c_void_p, c_void_p, c_void_p, c_void_p]
    vorbis.vorbis_analysis_headerout.restype = c_int
    vorbis.vorbis_analysis_buffer.argtypes = [c_void_p, c_int]
    vorbis.vorbis_analysis_buffer.restype = POINTER(POINTER(c_float))
    vorbis.vorbis_analysis_wrote.argtypes = [c_void_p, c_int]
    vorbis.vorbis_analysis_wrote.restype = c_int
    vorbis.vorbis_analysis_blockout.argtypes = [c_void_p, c_void_p]
    vorbis.vorbis_analysis_blockout.restype = c_int
    vorbis.vorbis_analysis.argtypes = [c_void_p, c_void_p]
    vorbis.vorbis_analysis.restype = c_int
    vorbis.vorbis_bitrate_addblock.argtypes = [c_void_p]
    vorbis.vorbis_bitrate_addblock.restype = c_int
    vorbis.vorbis_bitrate_flushpacket.argtypes = [c_void_p, c_void_p]
    vorbis.vorbis_bitrate_flushpacket.restype = c_int
    for fn in ("vorbis_block_clear", "vorbis_dsp_clear",
               "vorbis_comment_clear", "vorbis_info_clear"):
        getattr(vorbis, fn).argtypes = [c_void_p]

    venc.vorbis_encode_init_vbr.argtypes = [
        c_void_p, c_long, c_long, c_float]
    venc.vorbis_encode_init_vbr.restype = c_int

    ogg.ogg_stream_init.argtypes = [c_void_p, c_int]
    ogg.ogg_stream_init.restype = c_int
    ogg.ogg_stream_packetin.argtypes = [c_void_p, c_void_p]
    ogg.ogg_stream_packetin.restype = c_int
    ogg.ogg_stream_flush.argtypes = [c_void_p, c_void_p]
    ogg.ogg_stream_flush.restype = c_int
    ogg.ogg_stream_pageout.argtypes = [c_void_p, c_void_p]
    ogg.ogg_stream_pageout.restype = c_int
    ogg.ogg_stream_clear.argtypes = [c_void_p]


def available() -> bool:
    return _load() is not None


def is_ogg(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(4) == b"OggS"
    except OSError:
        return False


class OggFormatError(Exception):
    pass


@dataclass(frozen=True)
class OggInfo:
    samplerate: int
    channels: int
    frames: int
    subtype: str = "VORBIS"
    bits_per_sample: int = 0  # lossy — no PCM bit depth
    data_bytes: int = 0  # no PCM payload on disk; consumers fall back to
    #                      frames * bytes-per-frame (silencer stream gate)

    @property
    def duration(self) -> float:
        return self.frames / self.samplerate


class _Open:
    """ov_fopen/ov_clear RAII wrapper."""

    def __init__(self, path: str):
        libs = _load()
        if libs is None:
            raise OggFormatError(
                "OGG/Vorbis support needs the system libvorbis libraries "
                "(libvorbisfile.so.3), which were not found")
        self.vfile = libs[2]
        self.vf = ctypes.create_string_buffer(_OV_FILE_BYTES)
        rc = self.vfile.ov_fopen(path.encode(), self.vf)
        if rc != 0:
            raise OggFormatError(f"not a decodable Ogg/Vorbis file: {path} "
                                 f"(ov_fopen rc={rc})")
        self.open = True

    def info(self) -> OggInfo:
        vi = self.vfile.ov_info(self.vf, -1)
        if not vi:
            raise OggFormatError("ov_info failed")
        if int(vi.contents.rate) <= 0 or int(vi.contents.channels) <= 0:
            raise OggFormatError(
                f"invalid Vorbis header: {int(vi.contents.channels)}ch@"
                f"{int(vi.contents.rate)}")
        total = int(self.vfile.ov_pcm_total(self.vf, -1))
        return OggInfo(samplerate=int(vi.contents.rate),
                       channels=int(vi.contents.channels),
                       frames=max(total, 0))

    def close(self):
        if self.open:
            self.vfile.ov_clear(self.vf)
            self.open = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def info(path: str) -> OggInfo:
    with _Open(path) as o:
        return o.info()


def read(
    path: str, start: int = 0, frames: Optional[int] = None,
    always_2d: bool = False,
) -> Tuple[np.ndarray, int]:
    """Float32 samples [start, start+frames) at the native rate.

    Same contract as wavio.read/flac.read: mono returns 1-D unless
    ``always_2d``; reads are clamped at EOF.
    """
    with _Open(path) as o:
        inf = o.info()
        ch, total = inf.channels, inf.frames
        start = max(0, min(int(start), total))
        want = total - start if frames is None else max(
            0, min(int(frames), total - start))
        if start > 0:
            if o.vfile.ov_pcm_seek(o.vf, c_int64(start)) != 0:
                raise OggFormatError(f"ov_pcm_seek({start}) failed: {path}")
        out = np.empty((want, ch), np.float32)
        got = 0
        pcm = POINTER(POINTER(c_float))()
        bitstream = c_int(0)
        checked_link = None
        while got < want:
            n = int(o.vfile.ov_read_float(
                o.vf, byref(pcm), min(want - got, 4096), byref(bitstream)))
            if n == 0:  # EOF
                break
            if n < 0:  # hole/bad link — treat as decode error
                raise OggFormatError(f"ov_read_float error {n}: {path}")
            # chained streams decode per-link: a link whose channel count or
            # rate differs from the whole-file info would make pcm[c] an
            # invalid pointer / silently resample — reject instead of crash.
            # Only re-validate when the link index actually changes (one
            # FFI call per link, not per 4096-sample block).
            if bitstream.value != checked_link:
                li = o.vfile.ov_info(o.vf, bitstream.value)
                if not li:
                    # NULL info for a decodable link: can't prove pcm[c]
                    # is valid for all ch channels — reject, don't read
                    # through a possibly-dangling float**
                    raise OggFormatError(
                        f"ov_info returned NULL for link "
                        f"{bitstream.value}: {path}")
                if (int(li.contents.channels) != ch
                        or int(li.contents.rate) != inf.samplerate):
                    raise OggFormatError(
                        f"chained Ogg with per-link format change "
                        f"unsupported: {path} (link {bitstream.value}: "
                        f"{int(li.contents.channels)}ch@"
                        f"{int(li.contents.rate)})")
                checked_link = bitstream.value
            for c in range(ch):
                out[got:got + n, c] = np.ctypeslib.as_array(pcm[c], (n,))
            got += n
        if got < want:
            out = out[:got]
        if ch == 1 and not always_2d:
            out = out[:, 0]
        return np.ascontiguousarray(out), inf.samplerate


def write_vorbis(path: str, data: np.ndarray, samplerate: int,
                 quality: float = 0.4) -> None:
    """Encode float PCM ([-1,1], (n,) or (n,ch)) to an Ogg/Vorbis file.

    Exists to synthesize test vectors (the app writes WAV, like
    the reference); uses the standard libvorbisenc VBR analysis loop.
    """
    libs = _load()
    if libs is None:
        raise OggFormatError("libvorbis not available for encoding")
    ogg, vorbis, _vfile, venc = libs

    x = np.asarray(data, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    n, ch = x.shape

    # open the output FIRST: a bad path must fail before any libvorbis
    # state is allocated, and every successful init below is matched by a
    # *_clear in the finally so a mid-loop write error leaks nothing
    f = open(path, "wb")
    vi = _VorbisInfo()
    vorbis.vorbis_info_init(byref(vi))
    vc = _VorbisComment()
    vorbis.vorbis_comment_init(byref(vc))
    vd = ctypes.create_string_buffer(_DSP_BYTES)
    vb = ctypes.create_string_buffer(_BLOCK_BYTES)
    st = ctypes.create_string_buffer(_STREAM_BYTES)
    dsp_up = block_up = stream_up = False
    ok = False
    try:
        rc = venc.vorbis_encode_init_vbr(
            byref(vi), c_long(ch), c_long(samplerate), c_float(quality))
        if rc != 0:
            raise OggFormatError(f"vorbis_encode_init_vbr rc={rc}")
        if vorbis.vorbis_analysis_init(vd, byref(vi)) != 0:
            raise OggFormatError("vorbis_analysis_init failed")
        dsp_up = True
        if vorbis.vorbis_block_init(vd, vb) != 0:
            raise OggFormatError("vorbis_block_init failed")
        block_up = True
        if ogg.ogg_stream_init(st, c_int(0x5353)) != 0:  # fixed serial:
            raise OggFormatError("ogg_stream_init failed")  # deterministic
        stream_up = True

        h1, h2, h3 = _OggPacket(), _OggPacket(), _OggPacket()
        rc = vorbis.vorbis_analysis_headerout(
            vd, byref(vc), byref(h1), byref(h2), byref(h3))
        if rc != 0:
            # zero-initialized header packets would produce a structurally
            # broken stream that only fails later at decode
            raise OggFormatError(f"vorbis_analysis_headerout rc={rc}")
        page = _OggPage()

        def _write_page():
            f.write(ctypes.string_at(page.header, page.header_len))
            f.write(ctypes.string_at(page.body, page.body_len))

        for h in (h1, h2, h3):
            ogg.ogg_stream_packetin(st, byref(h))
        while ogg.ogg_stream_flush(st, byref(page)):
            _write_page()

        op = _OggPacket()
        CHUNK = 4096
        pos = 0
        while True:
            take = min(CHUNK, n - pos)
            if take > 0:
                buf = vorbis.vorbis_analysis_buffer(vd, c_int(take))
                for c in range(ch):
                    # bind the (possibly copied) contiguous column so it
                    # outlives the memmove — .ctypes.data alone would let
                    # the temporary free before the copy happens
                    col = np.ascontiguousarray(x[pos:pos + take, c])
                    ctypes.memmove(buf[c], col.ctypes.data, take * 4)
                pos += take
            if vorbis.vorbis_analysis_wrote(vd, c_int(take)) != 0:
                raise OggFormatError("vorbis_analysis_wrote failed")
            while vorbis.vorbis_analysis_blockout(vd, vb) == 1:
                if vorbis.vorbis_analysis(vb, None) != 0:
                    raise OggFormatError("vorbis_analysis failed")
                if vorbis.vorbis_bitrate_addblock(vb) != 0:
                    raise OggFormatError("vorbis_bitrate_addblock failed")
                while vorbis.vorbis_bitrate_flushpacket(vd, byref(op)):
                    ogg.ogg_stream_packetin(st, byref(op))
                    while ogg.ogg_stream_pageout(st, byref(page)):
                        _write_page()
            if take == 0:
                while ogg.ogg_stream_flush(st, byref(page)):
                    _write_page()
                break
        ok = True
    finally:
        f.close()
        if stream_up:
            ogg.ogg_stream_clear(st)
        if block_up:
            vorbis.vorbis_block_clear(vb)
        if dsp_up:
            vorbis.vorbis_dsp_clear(vd)
        vorbis.vorbis_comment_clear(byref(vc))
        vorbis.vorbis_info_clear(byref(vi))
        if not ok:
            # don't leave a 0-byte/truncated .ogg behind for a failed
            # encode — later directory scans would find a bogus vector
            try:
                os.remove(path)
            except OSError:
                pass
