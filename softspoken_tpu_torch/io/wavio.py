"""Self-contained RIFF/WAVE codec (numpy only).

A copy of the JAX package's ``io/wavio.py``: readers, ``write`` in every
subtype, the streaming ``WavWriter`` that promotes to RF64, and
``top16_from_raw`` for the lossy upload wires.
It stands in for the reference's ``soundfile``/``librosa`` reads
(``voice_activity.py:23-143``).

Supports:
  * PCM unsigned 8-bit, signed 16/24/32-bit, IEEE float32/float64
  * odd PCM widths (12/20/36/45/53-bit …) stored in their 1-8 byte
    containers (container size from nBlockAlign, per the spec; scaled at
    container full-scale like libsndfile) and signed 64-bit integer PCM
  * G.711 mu-law / A-law payloads (format tags 7 / 6)
  * big-endian RIFX containers (decode; subtypes gain a ``_BE`` suffix so
    little-endian fast paths dispatch away from them automatically)
  * MS ADPCM and IMA/DVI ADPCM 4-bit (decode; block-coded legacy recorders —
    libsndfile reads these, so the reference incidentally did too)
  * WAVE_FORMAT_EXTENSIBLE wrappers
  * random-access range reads (frame offsets) for streaming long recordings
  * headers-only probe (duration/sample-rate without loading samples,
    mirroring ``librosa.get_duration``/``get_samplerate`` in
    ``voice_activity.py:23-30``)

A file that is not RIFF/WAVE raises ``WavFormatError``; ``io/audio.py``
then tries the other containers.

Float conversion matches libsndfile/librosa conventions: integer PCM is
scaled by 1/2**(bits-1) into [-1, 1).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import BinaryIO, Optional, Tuple

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_ADPCM = 0x0002          # Microsoft ADPCM
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_ALAW = 0x0006           # G.711 A-law
WAVE_FORMAT_MULAW = 0x0007          # G.711 mu-law
WAVE_FORMAT_IMA_ADPCM = 0x0011      # IMA/DVI ADPCM
WAVE_FORMAT_EXTENSIBLE = 0xFFFE

# canonical integer-PCM subtype per CONTAINER width (bytes per sample).
# nBlockAlign sets the container; wValidBitsPerSample may be smaller (a
# 20-bit recorder writing 3-byte samples).  Decode scales at container
# full-scale, matching libsndfile's handling of e.g. 20-in-24-bit.
_PCM_SUBTYPE_BY_CONTAINER = {
    1: "PCM_U8", 2: "PCM_16", 3: "PCM_24", 4: "PCM_32",
    5: "PCM_40", 6: "PCM_48", 7: "PCM_56", 8: "PCM_64",
}

# exact (tag, bits) table for the byte-multiple widths; w64.py keys its
# (stricter) format dispatch on this
_SUBTYPE_BY_FMT = {
    (WAVE_FORMAT_PCM, 8): "PCM_U8",
    (WAVE_FORMAT_PCM, 16): "PCM_16",
    (WAVE_FORMAT_PCM, 24): "PCM_24",
    (WAVE_FORMAT_PCM, 32): "PCM_32",
    (WAVE_FORMAT_IEEE_FLOAT, 32): "FLOAT",
    (WAVE_FORMAT_IEEE_FLOAT, 64): "DOUBLE",
    (WAVE_FORMAT_ALAW, 8): "ALAW",
    (WAVE_FORMAT_MULAW, 8): "ULAW",
    (WAVE_FORMAT_ADPCM, 4): "MS_ADPCM",
    (WAVE_FORMAT_IMA_ADPCM, 4): "IMA_ADPCM",
}

# block-coded subtypes: no fixed bytes-per-frame; reads decode whole blocks
BLOCK_SUBTYPES = frozenset({"MS_ADPCM", "IMA_ADPCM"})


class WavFormatError(ValueError):
    pass


@dataclass(frozen=True)
class WavInfo:
    samplerate: int
    channels: int
    frames: int
    subtype: str
    bits_per_sample: int
    data_offset: int          # byte offset of sample data in the file
    data_bytes: int
    # block-coded (ADPCM) formats only; 0 for PCM/float subtypes
    block_align: int = 0
    samples_per_block: int = 0
    fmt_extra: bytes = b""    # fmt chunk bytes past the first 16 (coef table)
    # container bytes per sample (0 = legacy bits//8); differs from
    # bits_per_sample//8 for odd valid-bit widths (20-in-24-bit etc.)
    container_bytes: int = 0

    @property
    def bytes_per_sample(self) -> int:
        """Stored bytes per sample (the container, not the valid bits)."""
        return self.container_bytes or (self.bits_per_sample // 8)

    @property
    def duration(self) -> float:
        return self.frames / float(self.samplerate)


def _parse_header(f: BinaryIO) -> WavInfo:
    riff = f.read(12)
    if (len(riff) < 12 or riff[:4] not in (b"RIFF", b"RF64", b"RIFX")
            or riff[8:12] != b"WAVE"):
        raise WavFormatError("not a RIFF/WAVE file")
    is_rf64 = riff[:4] == b"RF64"
    # RIFX: the big-endian RIFF variant (old Mac tools; libsndfile reads
    # it) — every multi-byte header field AND the sample data are BE
    en = ">" if riff[:4] == b"RIFX" else "<"
    rf64_data_size = None

    fmt_tag = None
    channels = None
    samplerate = None
    bits = None
    block_align = 0
    fmt_extra = b""
    fact_frames = None
    data_offset = None
    data_bytes = None

    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, csize = struct.unpack(en + "4sI", hdr)
        if cid == b"ds64" and is_rf64:
            body = f.read(csize + (csize & 1))
            if len(body) < 16:
                # WavFormatError, not struct.error: probe()/read_any()
                # dispatch on the format-error type
                raise WavFormatError("truncated ds64 chunk")
            # riff_size(8) data_size(8) sample_count(8) ...
            rf64_data_size = struct.unpack("<Q", body[8:16])[0]
        elif cid == b"fmt ":
            body = f.read(csize + (csize & 1))
            if len(body) < 16:
                raise WavFormatError("truncated fmt chunk")
            fmt_tag, channels, samplerate, _brate, block_align, bits = struct.unpack(
                en + "HHIIHH", body[:16]
            )
            fmt_extra = bytes(body[16:])
            if fmt_tag == WAVE_FORMAT_EXTENSIBLE:
                if csize < 40 or len(body) < 28:
                    raise WavFormatError("truncated WAVE_FORMAT_EXTENSIBLE fmt chunk")
                # SubFormat GUID: the 4-byte Data1 field is the real format
                # tag, stored in the container's byte order (RIFX swaps it)
                fmt_tag = struct.unpack(en + "I", body[24:28])[0]
                if fmt_tag > 0xFFFF:
                    raise WavFormatError(
                        f"unsupported EXTENSIBLE SubFormat Data1=0x{fmt_tag:08x}")
                # rebase the extension onto the plain-fmt layout: keep
                # cbSize + the Samples union (== wSamplesPerBlock for block
                # codecs) and drop dwChannelMask + SubFormat GUID, so any
                # codec-specific trailing bytes (the MS ADPCM coefficient
                # table) land where _ms_coefs/_adpcm_samples_per_block
                # expect them — otherwise the channel-mask low word would
                # be misread as wNumCoef
                fmt_extra = bytes(body[16:20] + body[40:])
        elif cid == b"fact":
            body = f.read(csize + (csize & 1))
            if len(body) >= 4:
                fact_frames = struct.unpack(en + "I", body[:4])[0]
        elif cid == b"data" and data_offset is None:
            # first-wins: a malformed/concatenated WAV with a SECOND data
            # chunk must not redirect the payload — spec-conforming readers
            # (libsndfile) decode the first
            data_offset = f.tell()
            data_bytes = csize
            if is_rf64 and csize == 0xFFFFFFFF and rf64_data_size is not None:
                data_bytes = rf64_data_size
            # don't read the payload; skip past by the TRUE size (the 32-bit
            # field is a 0xFFFFFFFF sentinel in RF64 files)
            f.seek(data_bytes + (data_bytes & 1), os.SEEK_CUR)
        else:
            f.seek(csize + (csize & 1), os.SEEK_CUR)

    if fmt_tag is None or data_offset is None:
        raise WavFormatError("missing fmt or data chunk")
    subtype, container = _resolve_subtype(fmt_tag, bits, block_align,
                                          channels, en)
    # clamp to the bytes physically present: a recorder-crash file whose
    # data-chunk header overstates the payload must decode the samples that
    # exist, not crash downstream views/reshapes with short reads
    try:
        physical = os.fstat(f.fileno()).st_size - data_offset
        if 0 <= physical < data_bytes:
            data_bytes = physical
    except (OSError, AttributeError):  # non-file streams
        pass

    if subtype in BLOCK_SUBTYPES:
        if channels <= 0 or samplerate <= 0 or block_align <= 0:
            raise WavFormatError(
                f"invalid ADPCM fmt chunk: channels={channels} "
                f"block_align={block_align} samplerate={samplerate}")
        spb = _adpcm_samples_per_block(subtype, fmt_extra, block_align, channels)
        full, tail = divmod(data_bytes, block_align)
        frames = full * spb + _adpcm_tail_samples(subtype, tail, channels, spb)
        if fact_frames is not None and 0 < fact_frames < frames:
            # fact is authoritative when it TRIMS (final block padded out);
            # a fact overstating the physical payload is ignored
            frames = fact_frames
        return WavInfo(
            samplerate=samplerate, channels=channels, frames=frames,
            subtype=subtype, bits_per_sample=bits, data_offset=data_offset,
            data_bytes=data_bytes, block_align=block_align,
            samples_per_block=spb, fmt_extra=fmt_extra,
        )

    bytes_per_frame = channels * container
    if bytes_per_frame <= 0 or samplerate <= 0:  # fuzz: zeroed fmt fields
        raise WavFormatError(
            f"invalid fmt chunk: channels={channels} bits={bits} "
            f"samplerate={samplerate}")
    frames = data_bytes // bytes_per_frame
    return WavInfo(
        samplerate=samplerate,
        channels=channels,
        frames=frames,
        subtype=subtype,
        bits_per_sample=bits,
        data_offset=data_offset,
        data_bytes=frames * bytes_per_frame,
        container_bytes=container,
    )


def _resolve_subtype(fmt_tag: int, bits: int, block_align: int,
                     channels: int, en: str) -> Tuple[str, int]:
    """(subtype, container_bytes) for a parsed fmt chunk.

    Integer PCM dispatches on the CONTAINER width (nBlockAlign/nChannels,
    the stored bytes per sample) so odd valid-bit widths (12/20/36-bit …)
    decode from their 1-8 byte containers; big-endian (RIFX) variants gain
    a ``_BE`` suffix so subtype-keyed little-endian fast paths (the fused
    int16 wire, the native mono decode) dispatch away from them.
    """
    if fmt_tag in (WAVE_FORMAT_ADPCM, WAVE_FORMAT_IMA_ADPCM):
        if bits != 4 or en == ">":  # no big-endian ADPCM WAV exists
            raise WavFormatError(
                f"unsupported WAV format tag={fmt_tag} bits={bits}")
        return ("MS_ADPCM" if fmt_tag == WAVE_FORMAT_ADPCM
                else "IMA_ADPCM"), 0
    if fmt_tag in (WAVE_FORMAT_MULAW, WAVE_FORMAT_ALAW):
        # wBitsPerSample is unreliable for G.711: writers put 8 (the code
        # width), 0 (unset), or 16 (the decoded width, as AIFF-C COMM
        # does).  libsndfile ignores the field entirely for ULAW/ALAW, so
        # accept the observed variants; codes are bytes either way.
        if bits not in (0, 8, 16):
            raise WavFormatError(
                f"unsupported WAV format tag={fmt_tag} bits={bits}")
        # byte-wide codes: no endianness
        return ("ULAW" if fmt_tag == WAVE_FORMAT_MULAW else "ALAW"), 1
    if fmt_tag == WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            subtype, container = "FLOAT", 4
        elif bits == 64:
            subtype, container = "DOUBLE", 8
        else:
            raise WavFormatError(
                f"unsupported WAV format tag={fmt_tag} bits={bits}")
    elif fmt_tag == WAVE_FORMAT_PCM and bits > 0:
        # Precedence: a consistent nBlockAlign (divisible by channels,
        # container 1-8 bytes, wide enough for the valid bits) defines the
        # container, because over-wide containers (24-valid-bits-in-4-byte,
        # 12-in-2, 20-in-3 …) are only expressible through nBlockAlign.
        # The cost is that a garbage nBlockAlign that happens to divide
        # evenly (16-bit mono with nBlockAlign=3) decodes as the wider
        # container rather than erroring — deliberate: the header is
        # internally self-consistent and the frames/data-size math then
        # follows the container, matching how we size every other subtype.
        container = 0
        if channels > 0 and block_align > 0 and block_align % channels == 0:
            c = block_align // channels
            if 1 <= c <= 8 and c * 8 >= bits:
                container = c
        if container == 0:
            # inconsistent/absent nBlockAlign: fall back to the valid bits
            # (keeps reading liberal for malformed-but-decodable headers)
            container = (bits + 7) // 8
        subtype = _PCM_SUBTYPE_BY_CONTAINER.get(container)
        if subtype is None:
            raise WavFormatError(
                f"unsupported WAV format tag={fmt_tag} bits={bits}")
    else:
        raise WavFormatError(
            f"unsupported WAV format tag={fmt_tag} bits={bits}")
    if en == ">" and container > 1:
        subtype += "_BE"
    return subtype, container


def info(path: str) -> WavInfo:
    """Header-only probe (no sample data read)."""
    with open(path, "rb") as f:
        return _parse_header(f)


def _decode(raw: np.ndarray, subtype: str) -> np.ndarray:
    """Bytes → float32 in [-1, 1) using libsndfile scaling.

    ``*_BE`` subtypes (RIFX containers) decode the same widths with the
    byte order flipped; PCM_40/48/56/64 are the 5-8 byte integer
    containers, scaled at container full-scale.
    """
    en = "<"
    if subtype.endswith("_BE"):
        en, subtype = ">", subtype[:-3]
    if subtype == "PCM_U8":
        return (raw.view(np.uint8).astype(np.float32) - 128.0) / 128.0
    if subtype == "ULAW":
        from . import g711

        return g711.ulaw_to_f32(raw.view(np.uint8))
    if subtype == "ALAW":
        from . import g711

        return g711.alaw_to_f32(raw.view(np.uint8))
    if subtype == "PCM_16":
        return raw.view(en + "i2").astype(np.float32) / 32768.0
    if subtype == "PCM_24":
        b = raw.reshape(-1, 3)
        if en == ">":
            b = b[:, ::-1]
        vals = (
            b[:, 0].astype(np.uint32)
            | (b[:, 1].astype(np.uint32) << 8)
            | (b[:, 2].astype(np.uint32) << 16)
        ).astype(np.int32)
        vals = np.where(vals >= (1 << 23), vals - (1 << 24), vals)
        return vals.astype(np.float32) / 8388608.0
    if subtype == "PCM_32":
        return raw.view(en + "i4").astype(np.float32) / 2147483648.0
    if subtype in ("PCM_40", "PCM_48", "PCM_56", "PCM_64"):
        k = int(subtype[4:]) // 8
        return _decode_wide_int(raw, k, en)
    if subtype == "FLOAT":
        return raw.view(en + "f4").astype(np.float32)
    if subtype == "DOUBLE":
        return raw.view(en + "f8").astype(np.float32)
    raise WavFormatError(f"unsupported subtype {subtype}")


def _decode_wide_int(raw: np.ndarray, k: int, en: str) -> np.ndarray:
    """Signed k-byte (5 <= k <= 8) integer containers → float32.

    Assembles each sample into the TOP k bytes of an int64 (low bytes
    zero), so the arithmetic view handles the sign and one division by
    2^63 lands every width at container full-scale.
    """
    b = raw.reshape(-1, k)
    if en == "<":
        b = b[:, ::-1]  # most-significant byte first
    v = np.zeros(len(b), np.uint64)
    for i in range(k):  # b[:, 0] is the MSB → int64's top byte
        v |= b[:, i].astype(np.uint64) << np.uint64(8 * (7 - i))
    return (v.view(np.int64).astype(np.float64) / float(1 << 63)).astype(
        np.float32)


def top16_from_raw(raw: np.ndarray, subtype: str) -> np.ndarray:
    """Top 16 bits of mono integer-PCM sample bytes, as int16.

    For the fused engine's lossy wires (``engine/fused.py``): a 24/32-bit
    sample's low bits lie far below the compander's quantization step, so
    the host stages int16 without a float detour.  PCM_24/PCM_32 keep the
    top 16 bits (truncation toward −inf, ≤1 int16 LSB ≈ 3e-5 full scale;
    the finest mu-law step is ~1.7e-4); PCM_U8 converts exactly
    ((v−128)·256).  Not for exact paths.
    """
    if subtype == "PCM_24":
        b = raw.reshape(-1, 3)
        return np.ascontiguousarray(b[:, 1:3]).view("<i2")[:, 0]
    if subtype == "PCM_32":
        b = raw.reshape(-1, 4)
        return np.ascontiguousarray(b[:, 2:4]).view("<i2")[:, 0]
    if subtype == "PCM_U8":
        return ((raw.view(np.uint8).astype(np.int16) - 128) * 256).astype(np.int16)
    raise WavFormatError(f"top16_from_raw: unsupported subtype {subtype}")


# ---------------------------------------------------------------------------
# ADPCM decode (MS + IMA/DVI).  Block-coded: every block decodes
# independently from its own header, so decode vectorizes ACROSS blocks and
# loops only over the samples WITHIN one block (~500 numpy steps per file).
# Integer semantics verified bit-exact against SDL's WAV decoder on a real
# third-party MS ADPCM file (tests/test_real_audio.py): the predictor uses
# C truncating division, not an arithmetic shift.

_MS_ADAPT = np.array(
    [230, 230, 230, 230, 307, 409, 512, 614,
     768, 614, 512, 409, 307, 230, 230, 230], np.int64)
_MS_DEFAULT_COEFS = np.array(
    [[256, 0], [512, -256], [0, 0], [192, 64],
     [240, 0], [460, -208], [392, -232]], np.int64)

_IMA_INDEX = np.array([-1, -1, -1, -1, 2, 4, 6, 8,
                       -1, -1, -1, -1, 2, 4, 6, 8], np.int64)
_IMA_STEPS = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767], np.int64)


def _adpcm_samples_per_block(subtype: str, extra: bytes,
                             block_align: int, channels: int) -> int:
    """wSamplesPerBlock from the fmt extra bytes, else the layout formula."""
    # physical capacity of one block (header samples + stored nibbles)
    if subtype == "MS_ADPCM":
        capacity = (block_align - 7 * channels) * 2 // channels + 2
    else:  # IMA data arrives in 4-byte-per-channel word groups
        capacity = (block_align - 4 * channels) // (4 * channels) * 8 + 1
    spb = 0
    if len(extra) >= 4:  # cbSize(2) + wSamplesPerBlock(2)
        spb = struct.unpack("<H", extra[2:4])[0]
    if spb <= 0:
        spb = capacity
    if not (2 if subtype == "MS_ADPCM" else 1) <= spb <= capacity:
        # a header spb past the block's nibble capacity would index past
        # the decoded nibble matrix — malformed, fail cleanly
        raise WavFormatError(
            f"invalid {subtype} samples_per_block={spb} "
            f"(block_align={block_align} channels={channels} "
            f"holds at most {capacity})")
    return spb


def _adpcm_tail_samples(subtype: str, tail_bytes: int, channels: int,
                        samples_per_block: int) -> int:
    """Decodable samples in a truncated final block of ``tail_bytes``.

    Clamped to ``samples_per_block``: when the header wSamplesPerBlock is
    smaller than the block's physical nibble capacity, the decoders emit at
    most spb rows per block, so the capacity formula alone would overstate
    ``info().frames`` for a truncated final block.
    """
    if subtype == "MS_ADPCM":
        hdr = 7 * channels
        n = 0 if tail_bytes < hdr else 2 + (tail_bytes - hdr) * 2 // channels
    else:
        hdr = 4 * channels
        if tail_bytes < hdr:
            n = 0
        else:
            # IMA data arrives in 4-byte-per-channel word groups
            n = 1 + (tail_bytes - hdr) // (4 * channels) * 8
    return min(n, samples_per_block)


def _ms_coefs(extra: bytes) -> np.ndarray:
    """Predictor coefficient table from fmt extra; standard 7 pairs if absent."""
    if len(extra) >= 6:
        ncoef = struct.unpack("<H", extra[4:6])[0]
        if 0 < ncoef <= 256 and len(extra) >= 6 + 4 * ncoef:
            vals = struct.unpack(f"<{2 * ncoef}h", extra[6:6 + 4 * ncoef])
            return np.asarray(vals, np.int64).reshape(-1, 2)
    return _MS_DEFAULT_COEFS


def _div_trunc(q: np.ndarray, d: int) -> np.ndarray:
    """C-style integer division (truncation toward zero)."""
    return np.where(q >= 0, q // d, -((-q) // d))


def _decode_ms_adpcm(raw: bytes, inf: "WavInfo") -> np.ndarray:
    """Whole MS-ADPCM blocks → int16 samples, shape (n, channels)."""
    ch, ba, spb = inf.channels, inf.block_align, inf.samples_per_block
    coefs = _ms_coefs(inf.fmt_extra)
    tail = len(raw) % ba
    nvalid = (len(raw) // ba) * spb + _adpcm_tail_samples("MS_ADPCM", tail, ch, spb)
    if tail:
        raw = raw + b"\x00" * (ba - tail)
    nb = len(raw) // ba
    if nb == 0:
        return np.empty((0, ch), np.int16)
    A = np.frombuffer(raw, np.uint8).reshape(nb, ba)
    pidx = A[:, :ch].astype(np.int64)
    if pidx.max() >= len(coefs):
        raise WavFormatError(
            f"MS ADPCM predictor index {int(pidx.max())} outside the "
            f"{len(coefs)}-entry coefficient table")
    delta = A[:, ch:3 * ch].copy().view("<i2").astype(np.int64)
    s1 = A[:, 3 * ch:5 * ch].copy().view("<i2").astype(np.int64)
    s2 = A[:, 5 * ch:7 * ch].copy().view("<i2").astype(np.int64)
    c1, c2 = coefs[pidx, 0], coefs[pidx, 1]
    out = np.empty((nb, spb, ch), np.int16)
    out[:, 0, :] = s2
    if spb > 1:
        out[:, 1, :] = s1
    data = A[:, 7 * ch:]
    nib = np.empty((nb, data.shape[1] * 2), np.uint8)
    nib[:, 0::2] = data >> 4          # high nibble first
    nib[:, 1::2] = data & 0x0F
    nib = nib[:, :(spb - 2) * ch].reshape(nb, spb - 2, ch)
    signed = nib.astype(np.int64)
    signed = np.where(signed >= 8, signed - 16, signed)
    for k in range(spb - 2):
        pred = _div_trunc(s1 * c1 + s2 * c2, 256) + signed[:, k, :] * delta
        pred = np.clip(pred, -32768, 32767)
        s2, s1 = s1, pred
        delta = np.maximum(16, (_MS_ADAPT[nib[:, k, :]] * delta) // 256)
        out[:, k + 2, :] = pred
    return out.reshape(nb * spb, ch)[:nvalid]


def _decode_ima_adpcm(raw: bytes, inf: "WavInfo") -> np.ndarray:
    """Whole IMA-ADPCM blocks → int16 samples, shape (n, channels)."""
    ch, ba, spb = inf.channels, inf.block_align, inf.samples_per_block
    tail = len(raw) % ba
    nvalid = (len(raw) // ba) * spb + _adpcm_tail_samples("IMA_ADPCM", tail, ch, spb)
    if tail:
        raw = raw + b"\x00" * (ba - tail)
    nb = len(raw) // ba
    if nb == 0:
        return np.empty((0, ch), np.int16)
    A = np.frombuffer(raw, np.uint8).reshape(nb, ba)
    hdr = A[:, :4 * ch].reshape(nb, ch, 4)
    pred = np.ascontiguousarray(hdr[:, :, :2]).reshape(nb, -1) \
        .view("<i2").astype(np.int64)                       # (nb, ch)
    idx = hdr[:, :, 2].astype(np.int64)
    if idx.max() > 88:
        raise WavFormatError(
            f"IMA ADPCM step index {int(idx.max())} > 88")
    groups = (ba - 4 * ch) // (4 * ch)
    data = A[:, 4 * ch:4 * ch + groups * 4 * ch].reshape(nb, groups, ch, 4)
    nib = np.empty((nb, groups, ch, 8), np.uint8)
    nib[..., 0::2] = data & 0x0F      # low nibble first
    nib[..., 1::2] = data >> 4
    nib = nib.transpose(0, 1, 3, 2).reshape(nb, groups * 8, ch)
    out = np.empty((nb, spb, ch), np.int16)
    out[:, 0, :] = pred
    for k in range(spb - 1):
        n = nib[:, k, :].astype(np.int64)
        step = _IMA_STEPS[idx]
        diff = (step >> 3) + np.where(n & 1, step >> 2, 0) \
            + np.where(n & 2, step >> 1, 0) + np.where(n & 4, step, 0)
        pred = np.clip(np.where(n & 8, pred - diff, pred + diff),
                       -32768, 32767)
        idx = np.clip(idx + _IMA_INDEX[n], 0, 88)
        out[:, k + 1, :] = pred
    return out.reshape(nb * spb, ch)[:nvalid]


def _read_adpcm(path: str, inf: "WavInfo", start: int,
                frames: Optional[int]) -> np.ndarray:
    """Decode an ADPCM frame range → float32 (n, channels) in [-1, 1)."""
    start = max(0, min(int(start), inf.frames))
    if frames is None:
        frames = inf.frames - start
    frames = max(0, min(int(frames), inf.frames - start))
    spb, ba = inf.samples_per_block, inf.block_align
    b0 = start // spb
    b1 = (start + frames + spb - 1) // spb if frames else b0
    with open(path, "rb") as f:
        f.seek(inf.data_offset + b0 * ba)
        raw = f.read(max(0, min((b1 - b0) * ba, inf.data_bytes - b0 * ba)))
    dec = (_decode_ms_adpcm if inf.subtype == "MS_ADPCM"
           else _decode_ima_adpcm)(raw, inf)
    off = start - b0 * spb
    samples = dec[off:off + frames]
    return samples.astype(np.float32) / 32768.0


def read_raw(
    path: str, start: int = 0, frames: Optional[int] = None,
    want_subtype: Optional[str] = None,
) -> Tuple[Optional[np.ndarray], WavInfo]:
    """Read a frame range as raw sample bytes (uint8) + header info.

    Lets callers decode with fused fast paths (e.g. the native PCM16→mono
    kernel) without paying a generic decode first.  ``want_subtype`` gates
    the payload read on the header: a mismatch returns ``(None, info)``
    after the (cheap) header parse, so fast-path callers don't read bytes
    they would immediately discard.
    """
    with open(path, "rb") as f:
        inf = _parse_header(f)
        if want_subtype is not None and inf.subtype != want_subtype:
            return None, inf
        if inf.subtype in BLOCK_SUBTYPES:
            # block-coded: "raw sample bytes for a frame range" doesn't
            # exist — callers decode via read() instead
            return None, inf
        bpf = inf.channels * inf.bytes_per_sample
        start = max(0, min(int(start), inf.frames))
        if frames is None:
            frames = inf.frames - start
        frames = max(0, min(int(frames), inf.frames - start))
        f.seek(inf.data_offset + start * bpf)
        raw = np.frombuffer(f.read(frames * bpf), dtype=np.uint8)
    return raw, inf


def read(
    path: str,
    start: int = 0,
    frames: Optional[int] = None,
    always_2d: bool = False,
) -> Tuple[np.ndarray, int]:
    """Read float32 samples.

    Returns ``(data, samplerate)`` with ``data`` shaped ``(frames,)`` for mono
    or ``(frames, channels)`` otherwise (matching ``soundfile.read``).
    ``start``/``frames`` select a frame range; reads are clamped at EOF
    (mirrors the clamp in ``voice_activity.py:107-110``).
    """
    # one home for the clamp/seek/frombuffer body (read_raw) — the r3
    # fuzz-hardening clamps must not fork across copies
    raw, inf = read_raw(path, start=start, frames=frames)
    if raw is None and inf.subtype in BLOCK_SUBTYPES:
        data = _read_adpcm(path, inf, start, frames)
    else:
        data = _decode(raw, inf.subtype).reshape(-1, inf.channels)
    if inf.channels == 1 and not always_2d:
        data = data[:, 0]
    return data, inf.samplerate


_ENC = {
    "PCM_U8": ("u8", WAVE_FORMAT_PCM, 8),
    "PCM_16": ("<i2", WAVE_FORMAT_PCM, 16),
    "PCM_24": (None, WAVE_FORMAT_PCM, 24),
    "PCM_32": ("<i4", WAVE_FORMAT_PCM, 32),
    "FLOAT": ("<f4", WAVE_FORMAT_IEEE_FLOAT, 32),
    "DOUBLE": ("<f8", WAVE_FORMAT_IEEE_FLOAT, 64),
}


def _encode(data: np.ndarray, subtype: str) -> bytes:
    if subtype == "PCM_U8":
        q = np.clip(np.rint(data * 128.0) + 128.0, 0, 255).astype(np.uint8)
        return q.tobytes()
    if subtype == "PCM_16":
        q = np.clip(np.rint(data * 32768.0), -32768, 32767).astype("<i2")
        return q.tobytes()
    if subtype == "PCM_24":
        q = np.clip(np.rint(data * 8388608.0), -8388608, 8388607).astype(np.int64)
        q = (q & 0xFFFFFF).astype(np.uint32)
        out = np.empty(q.shape + (3,), dtype=np.uint8)
        out[..., 0] = q & 0xFF
        out[..., 1] = (q >> 8) & 0xFF
        out[..., 2] = (q >> 16) & 0xFF
        return out.tobytes()
    if subtype == "PCM_32":
        q = np.clip(np.rint(data * 2147483648.0), -2147483648, 2147483647).astype("<i4")
        return q.tobytes()
    if subtype == "FLOAT":
        return data.astype("<f4").tobytes()
    if subtype == "DOUBLE":
        return data.astype("<f8").tobytes()
    raise WavFormatError(f"unsupported subtype {subtype}")


def write(path: str, data: np.ndarray, samplerate: int, subtype: str = "PCM_16") -> None:
    """Write float samples to a WAV file.

    ``data`` is ``(frames,)`` or ``(frames, channels)`` float; the default
    PCM_16 subtype matches what ``soundfile.write`` produced for the
    reference's silenced output (``silencer_ui.py:998``).
    """
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    frames, channels = data.shape
    _, fmt_tag, bits = _ENC[subtype]
    payload = _encode(data, subtype)
    byte_rate = samplerate * channels * bits // 8
    block_align = channels * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF")
        # RIFF size counts the odd-payload pad byte written below (matches
        # WavWriter.close); omitting it truncates the final chunk for
        # strict parsers
        f.write(struct.pack("<I", 36 + len(payload) + (len(payload) & 1)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(
            struct.pack(
                "<IHHIIHH", 16, fmt_tag, channels, samplerate, byte_rate, block_align, bits
            )
        )
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)
        if len(payload) & 1:
            f.write(b"\x00")


class WavWriter:
    """Incremental WAV writer for streaming write-back of silenced audio.

    Lets the silencer stream multi-GB files chunk-by-chunk instead of holding
    the whole waveform in RAM (the reference loads entire files:
    ``silencer_ui.py:959``).

    **Auto-promotes to RF64** when the payload outgrows the 32-bit RIFF size
    fields: the header always reserves a 28-byte ``JUNK`` chunk right after
    the RIFF header (the libsndfile/EBU-3306 technique); on close it either
    stays ``JUNK`` (plain WAV, readers skip it) or is rewritten in place to
    the ``ds64`` chunk of an ``RF64`` file — so silencing a >4 GiB recording
    yields a valid large-file WAV instead of a struct.error.
    """

    # byte layout: RIFF(12) + JUNK/ds64(8+28) + fmt(8+16) + data hdr(8)
    _DS64_OFFSET = 12
    _DATA_SIZE_OFFSET = 12 + 36 + 24 + 4  # → the data chunk's 32-bit size field
    HEADER_BYTES = 12 + 36 + 24 + 8

    # promote a touch below 2^32 so riff_size (payload + header) also fits
    _RF64_THRESHOLD = 0xFFFFFFFF - 4096

    def __init__(self, path: str, samplerate: int, channels: int, subtype: str = "PCM_16"):
        self.path = path
        self.samplerate = samplerate
        self.channels = channels
        self.subtype = subtype
        self._f = open(path, "wb")
        self._payload_bytes = 0
        _, fmt_tag, bits = _ENC[subtype]
        self._block_align = channels * bits // 8
        # placeholder sizes; fixed up on close
        self._f.write(b"RIFF" + struct.pack("<I", 0) + b"WAVE")
        self._f.write(b"JUNK" + struct.pack("<I", 28) + b"\x00" * 28)
        byte_rate = samplerate * channels * bits // 8
        self._f.write(
            b"fmt "
            + struct.pack(
                "<IHHIIHH", 16, fmt_tag, channels, samplerate, byte_rate,
                self._block_align, bits
            )
        )
        self._f.write(b"data" + struct.pack("<I", 0))
        assert self._f.tell() == self.HEADER_BYTES

    def write(self, data: np.ndarray) -> None:
        data = np.asarray(data)
        if data.ndim == 1:
            data = data[:, None]
        if data.shape[1] != self.channels:  # not assert: corrupt WAV under -O
            raise ValueError(
                f"write() got {data.shape[1]} channel(s), writer has {self.channels}")
        payload = _encode(data, self.subtype)
        self._f.write(payload)
        self._payload_bytes += len(payload)

    def close(self) -> None:
        if self._f.closed:
            return
        if self._payload_bytes & 1:
            self._f.write(b"\x00")
        riff_size = self.HEADER_BYTES - 8 + self._payload_bytes + (self._payload_bytes & 1)
        if self._payload_bytes < self._RF64_THRESHOLD:
            self._f.seek(4)
            self._f.write(struct.pack("<I", riff_size))
            self._f.seek(self._DATA_SIZE_OFFSET)
            self._f.write(struct.pack("<I", self._payload_bytes))
        else:
            # RF64 promotion: 32-bit size fields become 0xFFFFFFFF sentinels,
            # JUNK becomes ds64 carrying the real 64-bit sizes (EBU Tech 3306)
            self._f.seek(0)
            self._f.write(b"RF64" + struct.pack("<I", 0xFFFFFFFF))
            self._f.seek(self._DS64_OFFSET)
            self._f.write(
                b"ds64"
                + struct.pack(
                    "<IQQQI",
                    28,
                    riff_size,
                    self._payload_bytes,
                    self._payload_bytes // self._block_align,
                    0,  # no per-chunk size table
                )
            )
            self._f.seek(self._DATA_SIZE_OFFSET)
            self._f.write(struct.pack("<I", 0xFFFFFFFF))
        self._f.close()

    def __enter__(self) -> "WavWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RawReader:
    """Persistent sequential range reader for the streaming pipelines.

    ``read_raw(path, …)`` reopens the file per chunk, which resets the
    kernel's readahead window every chunk; on a slow disk that reopen
    pattern bounds the end-to-end rate.  Keeping one handle with POSIX_FADV_SEQUENTIAL doubles
    the readahead window, and ``will_need`` hints the next chunk so the
    kernel prefetches it while the device computes the current one.
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self.info = _parse_header(self._f)
        if self.info.subtype in BLOCK_SUBTYPES:
            self._f.close()
            raise WavFormatError(
                f"RawReader cannot frame-address block-coded "
                f"{self.info.subtype}; use read()")
        self._bpf = self.info.channels * self.info.bytes_per_sample
        try:
            os.posix_fadvise(self._f.fileno(), 0, 0, os.POSIX_FADV_SEQUENTIAL)
        except (AttributeError, OSError):  # non-POSIX or odd fs
            pass

    def read_raw(self, start: int, frames: int) -> np.ndarray:
        """Raw sample bytes (uint8) for a frame range, clamped at EOF."""
        inf = self.info
        start = max(0, min(int(start), inf.frames))
        frames = max(0, min(int(frames), inf.frames - start))
        self._f.seek(inf.data_offset + start * self._bpf)
        return np.frombuffer(self._f.read(frames * self._bpf), dtype=np.uint8)

    def will_need(self, start: int, frames: int) -> None:
        """Async readahead hint for an upcoming range (no-op if unsupported)."""
        inf = self.info
        start = max(0, min(int(start), inf.frames))
        frames = max(0, min(int(frames), inf.frames - start))
        try:
            os.posix_fadvise(
                self._f.fileno(),
                inf.data_offset + start * self._bpf,
                frames * self._bpf,
                os.POSIX_FADV_WILLNEED,
            )
        except (AttributeError, OSError):
            pass

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "RawReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
