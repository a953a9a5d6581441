"""Ogg/Opus read and test-vector write over the system libopus and libogg,
through ctypes (a copy of the JAX package's ``io/opus.py``).

libsndfile >= 1.0.29 reads Ogg/Opus, so the reference's ``sf.read``
(voice_activity.py:37) accepts .opus field recordings.  Without libsndfile
or libopusfile, the two layers underneath are bound directly with ctypes:
**libogg** (container demux/mux) and **libopus** (the codec), and
``available()`` is False where they do not load.

Unlike Vorbis (where libvorbisfile handles the container), the Ogg demux
lives here:

  * pages are pulled with ``ogg_sync_*`` (CRC-checked, resyncs past garbage)
    and routed by serial number into one ``ogg_stream_state``;
  * the OpusHead ID header (RFC 7845 §5.1, complete on page 0 by spec) is
    parsed field by field: channels, pre-skip, output gain, channel mapping
    family 0/1/255; every file decodes through the multistream API (family 0
    is streams=1, coupled=channels-1) so the code path is uniform;
  * granule positions count 48 kHz samples including pre-skip; total length
    is ``last granule - preskip`` (found by a CRC-validated tail scan);
  * range reads seek via a page index (byte offset + granulepos per page,
    chained from offset 0 so packet bytes can't false-sync it; cached per
    (realpath, size, mtime) like mp3's scan cache) and re-enter the stream
    >= 80 ms (RFC 7845 §4.4 pre-roll) before the target: output after the
    pre-roll is converged-but-not-bit-exact vs a continuous decode, the
    same contract libsndfile/opusfile give.  ``start=0`` reads and pure
    forward reads (SequentialMonoReader) are bit-exact.

Opus always decodes at 48 kHz; ``info().samplerate`` is 48000 regardless of
the encoder's input rate (OpusHead's input_sample_rate is informational),
which matches libsndfile's behavior.

Encode (``write_opus``) writes test vectors (the app itself writes WAV,
like the reference): 20 ms frames, hand-built OpusHead/OpusTags, an
end-trimming granule so a round-trip recovers the exact sample count.
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
import threading
from ctypes import POINTER, byref, c_char_p, c_int, c_int32, c_long, c_ubyte, c_void_p
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

_OPUS_APPLICATION_AUDIO = 2049
_OPUS_SET_BITRATE = 4002        # opus_defines.h request codes (ABI-frozen)
_OPUS_SET_COMPLEXITY = 4010
_OPUS_GET_LOOKAHEAD = 4027
_MAX_FRAME = 5760               # 120 ms at 48 kHz — the largest legal packet
_PREROLL48 = 3840               # RFC 7845 §4.4: 80 ms decoder pre-roll
_PAGE_HDR = 27                  # fixed Ogg page header before the seg table

# opaque caller-allocated libogg state, overallocated vs the real ABI sizes
_SYNC_BYTES = 512               # ogg_sync_state ~ 64
_STREAM_BYTES = 2048            # ogg_stream_state ~ 408


class _OggPacket(ctypes.Structure):
    _fields_ = [
        ("packet", c_void_p),
        ("bytes", c_long),
        ("b_o_s", c_long),
        ("e_o_s", c_long),
        ("granulepos", ctypes.c_int64),
        ("packetno", ctypes.c_int64),
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


_libs = None
_tried = False
_load_lock = threading.Lock()


def _load():
    global _libs, _tried
    if _tried:
        return _libs
    with _load_lock:
        # double-checked (see oggvorbis._load: an unlocked load once
        # published _tried before _libs and misreported a decodable file)
        if _tried:
            return _libs
        return _load_locked()


def _load_locked():
    global _libs, _tried
    if os.environ.get("SOFTSPOKEN_DISABLE_OPUS"):
        _tried = True
        return None
    try:
        ogg = ctypes.CDLL("libogg.so.0")
        opus = ctypes.CDLL("libopus.so.0")
    except OSError as e:
        log.info("libogg/libopus unavailable (%s); Opus support disabled", e)
        _tried = True
        return None
    try:
        _bind(ogg, opus)
    except AttributeError as e:
        log.info("libogg/libopus missing symbol (%s); Opus support disabled", e)
        _tried = True
        return None
    _libs = (ogg, opus)
    _tried = True  # publish only after _libs is fully built
    return _libs


def _bind(ogg, opus):
    ogg.ogg_sync_init.argtypes = [c_void_p]
    ogg.ogg_sync_init.restype = c_int
    ogg.ogg_sync_clear.argtypes = [c_void_p]
    ogg.ogg_sync_buffer.argtypes = [c_void_p, c_long]
    ogg.ogg_sync_buffer.restype = c_void_p
    ogg.ogg_sync_wrote.argtypes = [c_void_p, c_long]
    ogg.ogg_sync_wrote.restype = c_int
    ogg.ogg_sync_pageout.argtypes = [c_void_p, POINTER(_OggPage)]
    ogg.ogg_sync_pageout.restype = c_int
    ogg.ogg_page_serialno.argtypes = [POINTER(_OggPage)]
    ogg.ogg_page_serialno.restype = c_int
    ogg.ogg_page_granulepos.argtypes = [POINTER(_OggPage)]
    ogg.ogg_page_granulepos.restype = ctypes.c_int64
    ogg.ogg_page_bos.argtypes = [POINTER(_OggPage)]
    ogg.ogg_page_bos.restype = c_int
    ogg.ogg_stream_init.argtypes = [c_void_p, c_int]
    ogg.ogg_stream_init.restype = c_int
    ogg.ogg_stream_clear.argtypes = [c_void_p]
    ogg.ogg_stream_pagein.argtypes = [c_void_p, POINTER(_OggPage)]
    ogg.ogg_stream_pagein.restype = c_int
    ogg.ogg_stream_packetout.argtypes = [c_void_p, POINTER(_OggPacket)]
    ogg.ogg_stream_packetout.restype = c_int
    ogg.ogg_stream_packetin.argtypes = [c_void_p, POINTER(_OggPacket)]
    ogg.ogg_stream_packetin.restype = c_int
    ogg.ogg_stream_flush.argtypes = [c_void_p, POINTER(_OggPage)]
    ogg.ogg_stream_flush.restype = c_int
    ogg.ogg_stream_pageout.argtypes = [c_void_p, POINTER(_OggPage)]
    ogg.ogg_stream_pageout.restype = c_int

    opus.opus_multistream_decoder_create.argtypes = [
        c_int32, c_int, c_int, c_int, POINTER(c_ubyte), POINTER(c_int)]
    opus.opus_multistream_decoder_create.restype = c_void_p
    opus.opus_multistream_decode_float.argtypes = [
        c_void_p, c_void_p, c_int32, c_void_p, c_int, c_int]
    opus.opus_multistream_decode_float.restype = c_int
    opus.opus_multistream_decoder_destroy.argtypes = [c_void_p]
    opus.opus_encoder_create.argtypes = [
        c_int32, c_int, c_int, POINTER(c_int)]
    opus.opus_encoder_create.restype = c_void_p
    opus.opus_encode_float.argtypes = [
        c_void_p, c_void_p, c_int, c_void_p, c_int32]
    opus.opus_encode_float.restype = c_int32
    opus.opus_encoder_destroy.argtypes = [c_void_p]
    # variadic: fix the handle+request prototype (ctypes passes extra args
    # through) — without it the c_void_p handle truncates to 32 bits
    opus.opus_encoder_ctl.argtypes = [c_void_p, c_int]
    opus.opus_encoder_ctl.restype = c_int
    opus.opus_strerror.argtypes = [c_int]
    opus.opus_strerror.restype = c_char_p


def available() -> bool:
    return _load() is not None


class OpusFormatError(Exception):
    pass


def _parse_page_at(buf: bytes, off: int):
    """Structural parse of one Ogg page header at a KNOWN page boundary.

    Returns (header_size, body_size, granulepos, serial, flags) or None.
    Only safe when ``off`` is a real page start (offset 0, or chained from
    one) — packet bytes can contain a fake 'OggS' otherwise.
    """
    if buf[off:off + 4] != b"OggS" or len(buf) < off + _PAGE_HDR:
        return None
    if buf[off + 4] != 0:  # stream_structure_version
        return None
    nseg = buf[off + 26]
    if len(buf) < off + _PAGE_HDR + nseg:
        return None
    segs = buf[off + _PAGE_HDR:off + _PAGE_HDR + nseg]
    body = sum(segs)
    granule = int.from_bytes(buf[off + 6:off + 14], "little", signed=True)
    # signed: matches ogg_page_serialno's c_int and ogg_stream_init's arg
    serial = int.from_bytes(buf[off + 14:off + 18], "little", signed=True)
    flags = buf[off + 5]
    return (_PAGE_HDR + nseg, body, granule, serial, flags)


def _find_opus_bos(head: bytes):
    """(serial, opushead_body) from the BOS page section, or None.

    RFC 7845 §3: the ID header is complete on the logical stream's first
    page, so it always fits this parse.
    """
    off = 0
    while True:
        p = _parse_page_at(head, off)
        if p is None:
            return None
        hsz, bsz, _gran, serial, flags = p
        if not flags & 0x02:  # past the BOS pages: no Opus stream here
            return None
        body = head[off + hsz:off + hsz + bsz]
        if body[:8] == b"OpusHead":
            return serial, body
        off += hsz + bsz


def is_opus(path: str) -> bool:
    """Cheap sniff: an Ogg file whose BOS section contains an OpusHead."""
    try:
        with open(path, "rb") as f:
            head = f.read(65536)
    except OSError:
        return False
    if head[:4] != b"OggS":
        return False
    return _find_opus_bos(head) is not None


@dataclass(frozen=True)
class OpusInfo:
    samplerate: int  # always 48000 — Opus decodes at 48 kHz by definition
    channels: int
    frames: int
    subtype: str = "OPUS"
    bits_per_sample: int = 0  # lossy — no PCM bit depth
    data_bytes: int = 0  # no PCM payload on disk; consumers fall back to
    #                      frames * bytes-per-frame (silencer stream gate)

    @property
    def duration(self) -> float:
        return self.frames / self.samplerate


@dataclass(frozen=True)
class _Head:
    channels: int
    preskip: int          # 48 kHz samples
    gain_scale: float     # linear, from the Q7.8 dB output_gain field
    streams: int
    coupled: int
    mapping: bytes


def _parse_opushead(body: bytes) -> _Head:
    if len(body) < 19 or body[:8] != b"OpusHead":
        raise OpusFormatError("malformed OpusHead")
    version = body[8]
    if version >> 4 != 0:  # major version must be 0 (RFC 7845 §5.1)
        raise OpusFormatError(f"unsupported OpusHead version {version}")
    ch = body[9]
    if ch < 1:
        raise OpusFormatError("OpusHead: zero channels")
    preskip = struct.unpack_from("<H", body, 10)[0]
    gain_q8 = struct.unpack_from("<h", body, 16)[0]
    family = body[18]
    if family == 0:
        if ch > 2:
            raise OpusFormatError(
                f"mapping family 0 allows 1-2 channels, got {ch}")
        streams, coupled = 1, ch - 1
        mapping = bytes(range(ch))
    else:
        # family 1 (Vorbis order) and 255 (discrete) carry an explicit table
        if len(body) < 21 + ch:
            raise OpusFormatError("OpusHead: truncated channel mapping table")
        streams = body[19]
        coupled = body[20]
        mapping = body[21:21 + ch]
        if streams < 1 or coupled > streams or streams + coupled > 255:
            raise OpusFormatError(
                f"OpusHead: invalid stream counts {streams}/{coupled}")
        for m in mapping:
            if m != 255 and m >= streams + coupled:
                raise OpusFormatError(f"OpusHead: mapping index {m} out of range")
    gain_scale = float(10.0 ** (gain_q8 / (20.0 * 256.0))) if gain_q8 else 1.0
    return _Head(ch, preskip, gain_scale, streams, coupled, mapping)


# ---------------------------------------------------------------------------
# page index (seeks): byte offset + granulepos per page, chained from 0


@dataclass(frozen=True)
class _PageIndexEntry:
    offset: int      # byte offset of the page start
    end: int         # byte offset just past the page
    granule: int     # granulepos (-1 = no packet completes on this page)
    cont: bool       # header flag 0x01: first packet continues a prior page


_index_cache: dict = {}
_index_cache_lock = threading.Lock()
_INDEX_CACHE_MAX = 32


def _index_cache_key(path: str):
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (os.path.realpath(path), st.st_size, st.st_mtime_ns)


def _build_page_index(path: str, serial: int) -> List[_PageIndexEntry]:
    """Walk pages from offset 0 (a guaranteed page boundary, so packet
    bytes can never false-sync the chain).  Stops at the first structural
    break — a truncated/corrupt tail just ends the index early, and seeks
    past it fall back to an error from the decode loop itself.
    """
    key = _index_cache_key(path)
    with _index_cache_lock:
        cached = _index_cache.get(key) if key is not None else None
    if cached is not None and cached[0] == serial:
        return cached[1]
    idx: List[_PageIndexEntry] = []
    CHUNK = 1 << 20
    MAXPAGE = _PAGE_HDR + 255 + 255 * 255  # header+segtable+max body
    with open(path, "rb") as f:
        buf = b""
        base = 0  # file offset of buf[0]
        off = 0
        eof = False
        while True:
            if len(buf) - off < MAXPAGE and not eof:
                more = f.read(CHUNK)
                if not more:
                    eof = True
                buf = buf[off:] + more
                base += off
                off = 0
            p = _parse_page_at(buf, off)
            if p is None:
                break
            hsz, bsz, gran, ser, flags = p
            if len(buf) - off < hsz + bsz:
                break  # truncated final page
            if ser == serial:
                idx.append(_PageIndexEntry(base + off, base + off + hsz + bsz,
                                           gran, bool(flags & 0x01)))
            off += hsz + bsz
    if key is not None:
        with _index_cache_lock:
            if len(_index_cache) >= _INDEX_CACHE_MAX and key not in _index_cache:
                _index_cache.pop(next(iter(_index_cache)))
            _index_cache[key] = (serial, idx)
    return idx


def _scan_last_granule(path: str, serial: int) -> Optional[int]:
    """Last granulepos of the stream via a CRC-validated tail scan.

    Feeds the file tail through a fresh ogg_sync — pageout resyncs past the
    partial leading page and CRC-rejects fake capture sequences, so this is
    safe from an arbitrary byte offset (unlike the structural parser).
    """
    libs = _load()
    assert libs is not None
    ogg = libs[0]
    size = os.path.getsize(path)
    win = 1 << 16
    while True:
        start = max(0, size - win)
        with open(path, "rb") as f:
            f.seek(start)
            data = f.read(size - start)
        oy = ctypes.create_string_buffer(_SYNC_BYTES)
        ogg.ogg_sync_init(oy)
        try:
            buf = ogg.ogg_sync_buffer(oy, len(data))
            if not buf:
                raise OpusFormatError("ogg_sync_buffer failed")
            ctypes.memmove(buf, data, len(data))
            ogg.ogg_sync_wrote(oy, len(data))
            page = _OggPage()
            last = None
            while ogg.ogg_sync_pageout(oy, byref(page)) == 1:
                if ogg.ogg_page_serialno(byref(page)) != serial:
                    continue
                g = int(ogg.ogg_page_granulepos(byref(page)))
                if g >= 0:
                    last = g
        finally:
            ogg.ogg_sync_clear(oy)
        if last is not None or start == 0:
            return last
        win *= 4


# ---------------------------------------------------------------------------
# decode


class _Handle:
    """Ogg demux + Opus decode with sample-accurate position tracking.

    Forward decode is bit-exact.  ``seek()`` re-enters the page stream
    >= 80 ms before the target (RFC 7845 pre-roll) with a fresh decoder;
    post-seek output is converged, not bit-exact (see module docstring).
    """

    READ_CHUNK = 1 << 16

    def __init__(self, path: str):
        libs = _load()
        if libs is None:
            raise OpusFormatError(
                "Opus support needs the system libogg + libopus "
                "(libogg.so.0 / libopus.so.0), which were not found")
        self.ogg, self.opus = libs
        self.path = path
        self._f = None
        self._oy = None
        self._os = None
        self._dec = None
        self._sync_up = False
        self._stream_up = False

        try:
            with open(path, "rb") as f:
                head = f.read(65536)
        except OSError as e:
            raise OpusFormatError(f"cannot open {path}: {e}") from e
        found = _find_opus_bos(head)
        if found is None:
            raise OpusFormatError(f"not an Ogg/Opus file: {path}")
        self.serial, hdr_body = found
        self.head = _parse_opushead(hdr_body)
        self.channels = self.head.channels
        self.preskip = self.head.preskip

        last = _scan_last_granule(path, self.serial)
        if last is None:
            raise OpusFormatError(f"no completed Opus packets: {path}")
        self.total = max(0, last - self.preskip)

        err = c_int(0)
        mapping = (c_ubyte * len(self.head.mapping))(*self.head.mapping)
        self._dec = self.opus.opus_multistream_decoder_create(
            48000, self.channels, self.head.streams, self.head.coupled,
            mapping, byref(err))
        if not self._dec or err.value != 0:
            self._dec = None
            raise OpusFormatError(
                f"opus decoder create failed: {self._strerror(err.value)}")

        self._pcm = np.empty((_MAX_FRAME, self.channels), np.float32)
        self._open_stream(0)
        self._skip_header_packets = 2  # OpusHead + OpusTags
        self._decoded48 = 0            # granule of the next decoded sample
        self._next_out = 0             # user-facing index of next sample
        self._allow_hole = False       # one continued-packet hole post-seek

    # -- libogg plumbing ----------------------------------------------------

    def _strerror(self, code: int) -> str:
        try:
            msg = self.opus.opus_strerror(code)
            return msg.decode() if msg else str(code)
        except Exception:  # noqa: BLE001 — diagnostics only
            return str(code)

    def _open_stream(self, byte_offset: int) -> None:
        """(Re)start demuxing from a page boundary at ``byte_offset``."""
        self._close_stream()
        self._f = open(self.path, "rb")
        self._f.seek(byte_offset)
        self._oy = ctypes.create_string_buffer(_SYNC_BYTES)
        self.ogg.ogg_sync_init(self._oy)
        self._sync_up = True
        self._os = ctypes.create_string_buffer(_STREAM_BYTES)
        if self.ogg.ogg_stream_init(self._os, self.serial) != 0:
            raise OpusFormatError("ogg_stream_init failed")
        self._stream_up = True
        self._eof = False

    def _close_stream(self) -> None:
        if self._stream_up:
            self.ogg.ogg_stream_clear(self._os)
            self._stream_up = False
        if self._sync_up:
            self.ogg.ogg_sync_clear(self._oy)
            self._sync_up = False
        if self._f is not None:
            self._f.close()
            self._f = None

    def _next_packet(self) -> Optional[bytes]:
        """The next packet of our serial, or None at end of stream."""
        op = _OggPacket()
        page = _OggPage()
        while True:
            rc = self.ogg.ogg_stream_packetout(self._os, byref(op))
            if rc == 1:
                self._allow_hole = False
                return ctypes.string_at(op.packet, op.bytes)
            if rc == -1:
                # hole: expected exactly once after a mid-stream seek (the
                # resume page's first packet is a continuation); anywhere
                # else it means a corrupt stream
                if self._allow_hole:
                    self._allow_hole = False
                    continue
                raise OpusFormatError(f"hole in Ogg stream: {self.path}")
            # need another page
            while True:
                prc = self.ogg.ogg_sync_pageout(self._oy, byref(page))
                if prc == 1:
                    if self.ogg.ogg_page_serialno(byref(page)) == self.serial:
                        if self.ogg.ogg_stream_pagein(self._os, byref(page)) != 0:
                            raise OpusFormatError("ogg_stream_pagein failed")
                        break  # try packetout again
                    continue  # other logical stream: skip
                if prc < 0:
                    continue  # resyncing past garbage — keep pulling
                if self._eof:
                    return None
                data = self._f.read(self.READ_CHUNK)
                if not data:
                    self._eof = True
                    continue
                buf = self.ogg.ogg_sync_buffer(self._oy, len(data))
                if not buf:
                    raise OpusFormatError("ogg_sync_buffer failed")
                ctypes.memmove(buf, data, len(data))
                self.ogg.ogg_sync_wrote(self._oy, len(data))

    # -- decode -------------------------------------------------------------

    def _decode_next(self) -> Optional[np.ndarray]:
        """Decode the next audio packet → (n, ch) float32 in user range.

        Applies pre-skip / end trimming / output gain; advances position.
        Returns None at end of stream; may return an empty block when a
        packet falls entirely inside the pre-skip region.
        """
        while self._skip_header_packets:
            if self._next_packet() is None:
                return None
            self._skip_header_packets -= 1
        pkt = self._next_packet()
        if pkt is None:
            return None
        n = self.opus.opus_multistream_decode_float(
            self._dec, pkt, len(pkt), self._pcm.ctypes.data, _MAX_FRAME, 0)
        if n < 0:
            raise OpusFormatError(
                f"opus decode error: {self._strerror(n)}: {self.path}")
        lo48 = self._decoded48
        self._decoded48 += n
        # user-facing sample range of this block
        lo = max(0, lo48 - self.preskip)
        hi = min(self.total, self._decoded48 - self.preskip)
        if hi <= lo:
            return self._pcm[:0]
        a = max(0, self.preskip - lo48)       # leading pre-skip trim
        block = self._pcm[a:a + (hi - lo)]
        if self.head.gain_scale != 1.0:
            block = block * np.float32(self.head.gain_scale)
        self._next_out = hi
        return block

    def read_into(self, out: np.ndarray) -> int:
        """Fill the float32 (n, ch) array from the current position."""
        want = out.shape[0]
        got = 0
        while got < want:
            block = self._decode_next()
            if block is None:
                break
            n = min(len(block), want - got)
            out[got:got + n] = block[:n]
            got += n
            if n < len(block):
                # partially consumed packet: rewind position bookkeeping so
                # a subsequent read re-seeks (one-shot reads never hit this)
                self._next_out -= len(block) - n
        return got

    def seek(self, frame: int) -> None:
        """Position so the next ``read_into`` starts at user sample ``frame``.

        frame == 0 restarts from the stream head (bit-exact); anything else
        re-enters >= 80 ms early and decode-discards up to the target.
        """
        frame = max(0, min(int(frame), self.total))
        target48 = frame + self.preskip
        resume_off = 0
        base48 = 0
        if frame > 0:
            idx = _build_page_index(self.path, self.serial)
            # last page whose granule <= target - preroll: every packet on
            # LATER pages starts at or after that granule
            floor_g = target48 - _PREROLL48
            best_i = None
            for i, e in enumerate(idx):
                if e.granule < 0:
                    continue
                if e.granule <= floor_g:
                    best_i = i
                else:
                    break
            if best_i is not None:
                j = best_i + 1
                # never resume on a page whose first packet is a
                # CONTINUATION: libogg drops the headless fragment (the
                # one-shot hole below) and the dropped packet's duration
                # would silently time-shift every later sample — walk back
                # to a page that starts a fresh packet
                while 0 < j < len(idx) and idx[j].cont:
                    j -= 1
                base = None
                for k in range(j - 1, -1, -1):
                    if idx[k].granule >= 0:
                        base = idx[k].granule
                        break
                if j > 0 and base is not None:
                    resume_off = idx[j].offset if j < len(idx) else idx[-1].end
                    base48 = base
        # fresh decoder state (packet history is invalid after a jump)
        err = c_int(0)
        mapping = (c_ubyte * len(self.head.mapping))(*self.head.mapping)
        dec = self.opus.opus_multistream_decoder_create(
            48000, self.channels, self.head.streams, self.head.coupled,
            mapping, byref(err))
        if not dec or err.value != 0:
            raise OpusFormatError(
                f"opus decoder create failed: {self._strerror(err.value)}")
        self.opus.opus_multistream_decoder_destroy(self._dec)
        self._dec = dec
        self._open_stream(resume_off)
        if resume_off == 0:
            self._skip_header_packets = 2
            self._decoded48 = 0
            self._allow_hole = False
        else:
            self._skip_header_packets = 0
            self._decoded48 = base48
            # the resume page never starts mid-packet (seek walks back past
            # continued pages), but libogg still flags the page-number
            # discontinuity as one empty hole — consume exactly that
            self._allow_hole = True
        self._next_out = max(0, self._decoded48 - self.preskip)
        # decode-discard up to the target
        while self._next_out < frame:
            block = self._decode_next()
            if block is None:
                break
            over = self._next_out - frame
            if over > 0:
                # copy: `block` can be a view into the reused _pcm buffer,
                # which the next _decode_next overwrites
                self._stash = block[len(block) - over:].copy()
                return
        self._stash = None

    _stash: Optional[np.ndarray] = None

    def read_at(self, start: int, out: np.ndarray) -> int:
        """seek + read, serving any seek-overshoot stash first."""
        self.seek(start)
        got = 0
        want = out.shape[0]
        if self._stash is not None and want:
            n = min(len(self._stash), want)
            out[:n] = self._stash[:n]
            got = n
            self._stash = None
        if got < want:
            got += self.read_into(out[got:])
        return got

    def info(self) -> OpusInfo:
        return OpusInfo(samplerate=48000, channels=self.channels,
                        frames=self.total)

    def close(self):
        if self._dec is not None:
            self.opus.opus_multistream_decoder_destroy(self._dec)
            self._dec = None
        self._close_stream()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def info(path: str) -> OpusInfo:
    """Header-only probe (BOS parse + CRC-validated tail scan, no decode)."""
    libs = _load()
    if libs is None:
        raise OpusFormatError(
            "Opus support needs the system libogg + libopus, not found")
    try:
        with open(path, "rb") as f:
            head = f.read(65536)
    except OSError as e:
        raise OpusFormatError(f"cannot open {path}: {e}") from e
    found = _find_opus_bos(head)
    if found is None:
        raise OpusFormatError(f"not an Ogg/Opus file: {path}")
    serial, body = found
    h = _parse_opushead(body)
    last = _scan_last_granule(path, serial)
    if last is None:
        raise OpusFormatError(f"no completed Opus packets: {path}")
    return OpusInfo(samplerate=48000, channels=h.channels,
                    frames=max(0, last - h.preskip))


def read(
    path: str, start: int = 0, frames: Optional[int] = None,
    always_2d: bool = False,
) -> Tuple[np.ndarray, int]:
    """Float32 samples [start, start+frames) at 48 kHz.

    Same contract as wavio.read/flac.read/oggvorbis.read: mono returns 1-D
    unless ``always_2d``; reads are clamped at EOF.  ``start=0`` is
    bit-exact vs a continuous decode; ``start>0`` re-enters with an 80 ms
    pre-roll (RFC 7845 §4.4) and is converged-but-not-bit-exact — the same
    contract opusfile/libsndfile give.
    """
    with _Handle(path) as h:
        ch, total = h.channels, h.total
        start = max(0, min(int(start), total))
        want = total - start if frames is None else max(
            0, min(int(frames), total - start))
        out = np.empty((want, ch), np.float32)
        if want:
            got = h.read_at(start, out)
            if got < want:
                out = out[:got]
        if ch == 1 and not always_2d:
            out = out[:, 0]
        return np.ascontiguousarray(out), 48000


class SequentialMonoReader:
    """Mono float32 range reads over one persistent handle, bit-exactly.

    The chunked engines read almost-sequential ranges that overlap backward
    by a little filter context; a decoder seek there would replace exact
    samples with converged-after-pre-roll ones and break the stream_chunks
    bit-exactness contract.  Instead this keeps a rolling history of the
    most recent ``history`` decoded samples and serves backward overlap
    from it — the decoder itself only ever moves forward, so every sample
    delivered is from the one continuous decode.
    """

    def __init__(self, path: str, history: int = 1 << 18):
        self._h = _Handle(path)
        self.info = self._h.info()
        self._history = int(history)
        self._buf = np.empty(0, np.float32)   # tail of delivered samples
        self._buf_start = 0                   # user index of _buf[0]

    def _mono(self, block: np.ndarray) -> np.ndarray:
        if self._h.channels == 1:
            return block[:, 0]
        return block.mean(axis=1, dtype=np.float64).astype(np.float32)

    def read(self, start: int, frames: int) -> np.ndarray:
        total = self.info.frames
        start = max(0, min(int(start), total))
        want = max(0, min(int(frames), total - start))
        end = start + want
        buf_end = self._buf_start + len(self._buf)
        if start < self._buf_start:
            raise OpusFormatError(
                f"backward read past history: start={start} < buffered "
                f"{self._buf_start} (history={self._history}); raise "
                f"SequentialMonoReader(history=) for this access pattern")
        # decode forward until the buffer covers [start, end)
        while buf_end < end:
            block = self._h._decode_next()
            if block is None:
                break
            mono = self._mono(block)
            self._buf = np.concatenate([self._buf, mono])
            buf_end += len(mono)
            if len(self._buf) > self._history + (end - self._buf_start):
                drop = len(self._buf) - self._history - max(
                    0, end - self._buf_start)
                drop = max(0, min(drop, start - self._buf_start))
                if drop:
                    self._buf = self._buf[drop:]
                    self._buf_start += drop
        lo = start - self._buf_start
        out = np.ascontiguousarray(self._buf[lo:lo + want])
        # trim history now that the read is served
        keep_from = max(0, len(self._buf) - self._history)
        if keep_from:
            self._buf = self._buf[keep_from:]
            self._buf_start += keep_from
        return out

    def close(self):
        self._h.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# encode (test vectors)


_OPUS_RATES = (8000, 12000, 16000, 24000, 48000)


def write_opus(path: str, data: np.ndarray, samplerate: int,
               bitrate_kbps: int = 64) -> None:
    """Encode float PCM ([-1,1], (n,) or (n,ch)) to an Ogg/Opus file.

    Exists to synthesize test vectors (the app writes WAV, like
    the reference).  20 ms frames; the final granule end-trims the padding
    so a round-trip recovers the exact original sample count.  Note the
    decoded stream is at 48 kHz regardless of ``samplerate`` (that is how
    Opus works, and how libsndfile reads it back).
    """
    libs = _load()
    if libs is None:
        raise OpusFormatError("libopus not available for encoding")
    ogg, opus = libs

    x = np.asarray(data, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    n, ch = x.shape
    if ch not in (1, 2):
        raise OpusFormatError(f"Opus encode supports 1-2 channels, got {ch}")
    if samplerate not in _OPUS_RATES:
        raise OpusFormatError(
            f"not an Opus input rate: {samplerate} (must be one of "
            f"{_OPUS_RATES}; the app writes WAV — this is for test vectors)")

    frame = samplerate // 50  # 20 ms
    err = c_int(0)
    enc = opus.opus_encoder_create(samplerate, ch, _OPUS_APPLICATION_AUDIO,
                                   byref(err))
    if not enc or err.value != 0:
        raise OpusFormatError(f"opus_encoder_create failed ({err.value})")
    ok = False
    f = open(path, "wb")  # bad path fails before any encoding
    st = ctypes.create_string_buffer(_STREAM_BYTES)
    stream_up = False
    try:
        opus.opus_encoder_ctl(enc, c_int(_OPUS_SET_BITRATE),
                              c_int(int(bitrate_kbps) * 1000))
        opus.opus_encoder_ctl(enc, c_int(_OPUS_SET_COMPLEXITY), c_int(10))
        look = c_int(0)
        opus.opus_encoder_ctl(enc, c_int(_OPUS_GET_LOOKAHEAD), byref(look))
        preskip48 = look.value * 48000 // samplerate

        if ogg.ogg_stream_init(st, 0x5350) != 0:  # fixed serial: determinism
            raise OpusFormatError("ogg_stream_init failed")
        stream_up = True
        page = _OggPage()

        def _write_pages(flush: bool):
            fn = ogg.ogg_stream_flush if flush else ogg.ogg_stream_pageout
            while fn(st, byref(page)):
                f.write(ctypes.string_at(page.header, page.header_len))
                f.write(ctypes.string_at(page.body, page.body_len))

        def _packetin(payload: bytes, granule: int, bos: bool, eos: bool):
            op = _OggPacket()
            buf = ctypes.create_string_buffer(payload, len(payload))
            op.packet = ctypes.cast(buf, c_void_p)
            op.bytes = len(payload)
            op.b_o_s = 1 if bos else 0
            op.e_o_s = 1 if eos else 0
            op.granulepos = granule
            op.packetno = _packetin.no
            _packetin.no += 1
            if ogg.ogg_stream_packetin(st, byref(op)) != 0:
                raise OpusFormatError("ogg_stream_packetin failed")
        _packetin.no = 0

        head = (b"OpusHead" + bytes([1, ch])
                + struct.pack("<HIh", preskip48, samplerate, 0)
                + bytes([0]))
        _packetin(head, 0, True, False)
        _write_pages(flush=True)  # ID header alone on page 0 (RFC 7845 §3)
        vendor = b"softspoken_tpu"
        tags = (b"OpusTags" + struct.pack("<I", len(vendor)) + vendor
                + struct.pack("<I", 0))
        _packetin(tags, 0, False, False)
        _write_pages(flush=True)

        total48 = preskip48 + n * 48000 // samplerate
        pkt = np.empty(4000, np.uint8)
        pos = 0
        # the encoder delays output by its lookahead: input sample i comes
        # out at position i+lookahead, and pre-skip trims exactly that — so
        # feed n+lookahead samples (zero tail) to flush all real input out
        nframes = max(1, -(-(n + look.value) // frame))
        for i in range(nframes):
            chunk = x[pos:pos + frame]
            if len(chunk) < frame:
                pad = np.zeros((frame, ch), np.float32)
                pad[:len(chunk)] = chunk
                chunk = pad
            pos += frame
            chunk = np.ascontiguousarray(chunk)
            m = opus.opus_encode_float(enc, chunk.ctypes.data, frame,
                                       pkt.ctypes.data, pkt.nbytes)
            if m < 0:
                raise OpusFormatError(f"opus_encode_float rc={m}")
            last = i == nframes - 1
            # granulepos counts decoded 48 kHz samples INCLUDING pre-skip;
            # every 20 ms packet decodes to 960 of them.  The final granule
            # is clamped to preskip+n*48k/R — that is the end-trim signal.
            _packetin(pkt[:m].tobytes(),
                      total48 if last else (i + 1) * 960, False, last)
            _write_pages(flush=False)
        _write_pages(flush=True)
        ok = True
    finally:
        f.close()
        if stream_up:
            ogg.ogg_stream_clear(st)
        opus.opus_encoder_destroy(enc)
        if not ok:
            # no 0-byte/truncated .opus left behind for a failed encode
            try:
                os.remove(path)
            except OSError:
                pass
