"""Shared decode/read helpers for the simple interleaved-PCM containers.

AU, CAF, NIST SPHERE and W64 differ only in their headers; the payload is
interleaved fixed-width frames.  This is the one home for the clamped
``read()`` body and the byte-order-aware sample decode those containers
share (the same single-home rule ``wavio.py`` applies to its own clamp/
seek/frombuffer body) — a bounds or endianness fix must not fork across
per-container copies.

The reference reads all of these incidentally through libsndfile
(``voice_activity.py:37`` ``sf.read``); see the individual container
modules for the header formats.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Type

import numpy as np

from . import g711


def decode_pcm(raw: np.ndarray, subtype: str, little_endian: bool,
               error_cls: Type[ValueError] = ValueError) -> np.ndarray:
    """Flat uint8 payload bytes → flat float32 samples in [-1, 1).

    Handles the encodings the AU/CAF/SPHERE containers can carry: G.711
    mu-law/A-law, SIGNED PCM 8/16/24/32 and float32/64 in either byte
    order.  (WAV/W64 8-bit PCM is unsigned — those stay on
    ``wavio._decode``.)  Unsupported subtypes raise ``error_cls`` so each
    container reports its own format-error type.
    """
    bo = "<" if little_endian else ">"
    if subtype == "ULAW":
        return g711.ulaw_to_f32(raw)
    if subtype == "ALAW":
        return g711.alaw_to_f32(raw)
    if subtype == "PCM_8":
        return raw.view(np.int8).astype(np.float32) / 128.0
    if subtype == "PCM_16":
        return raw.view(f"{bo}i2").astype(np.float32) / 32768.0
    if subtype == "PCM_24":  # 3-byte signed, sign-extended via shift pair
        b = raw.reshape(-1, 3)
        if little_endian:
            b = b[:, ::-1]
        vals = (
            (b[:, 0].astype(np.uint32) << 16)
            | (b[:, 1].astype(np.uint32) << 8)
            | b[:, 2].astype(np.uint32)
        ).astype(np.int32)
        vals = (vals << 8) >> 8
        return vals.astype(np.float32) / 8388608.0
    if subtype == "PCM_32":
        return raw.view(f"{bo}i4").astype(np.float32) / 2147483648.0
    if subtype == "FLOAT":
        return raw.view(f"{bo}f4").astype(np.float32)
    if subtype == "DOUBLE":
        return raw.view(f"{bo}f8").astype(np.float32)
    raise error_cls(f"unsupported subtype {subtype}")


def read_clamped(
    path: str,
    parse: Callable,
    decode: Callable[[np.ndarray, object], np.ndarray],
    start: int = 0,
    frames: Optional[int] = None,
    always_2d: bool = False,
) -> Tuple[np.ndarray, int]:
    """Float32 samples with the same EOF clamping as ``wavio.read``.

    ``parse(f) -> info`` must yield ``channels / bits_per_sample / frames /
    data_offset / samplerate`` (the ``WavInfo`` duck type all the container
    modules share); ``decode(raw_uint8, info)`` returns flat float32.
    """
    with open(path, "rb") as f:
        inf = parse(f)
        # frames are addressed by the CONTAINER width when the info object
        # carries one (G.711 with bits=16 decoded width, over-wide PCM
        # containers); bits//8 is only the fallback for plain infos
        bps = getattr(inf, "bytes_per_sample", None)
        if bps is None:
            bps = inf.bits_per_sample // 8
        bpf = inf.channels * bps
        start = max(0, min(int(start), inf.frames))
        if frames is None:
            frames = inf.frames - start
        frames = max(0, min(int(frames), inf.frames - start))
        f.seek(inf.data_offset + start * bpf)
        raw = np.frombuffer(f.read(frames * bpf), dtype=np.uint8)
    data = decode(raw, inf).reshape(-1, inf.channels)
    if inf.channels == 1 and not always_2d:
        data = data[:, 0]
    return data, inf.samplerate
