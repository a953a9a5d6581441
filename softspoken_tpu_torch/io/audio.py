"""Audio loading with the reference's semantics, over the port's readers.

Mirrors the behaviour (not the implementation) of the reference's
``root/code/backend/voice_activity.py`` and the JAX package's
``io/audio.py``:

  * ``probe`` / ``read_any`` — format sniffing in the JAX package's order:
                                WAV/RF64/RIFX, FLAC, AIFF/AIFC, Ogg (Opus,
                                else Vorbis), the PCM containers (W64, CAF,
                                AU, SPHERE), then MP3
  * ``get_audio_data``        — voice_activity.py:23-30 (header-only probe)
  * ``load_audio``            — voice_activity.py:32-69 (whole file or a 3 s
                                slice, channel-mean downmix, resample to
                                22050 Hz, (None, None) on a decode failure)
  * ``load_audio_startstop``  — voice_activity.py:72-143 (a seconds range,
                                stop clamped at EOF)
  * ``stream_chunks``         — bounded-memory internal-rate chunks for
                                multi-hour recordings (the host pipeline's
                                streaming decode)

MP3, Ogg Vorbis and Opus decode through the system libraries
(``mp3``, ``oggvorbis``, ``opus``); where a library does not load, its
reader raises its format error, as in the JAX package.
"""

from __future__ import annotations

import logging
import math
import struct
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_CONFIG
from . import aiff, au, caf, flac, mp3, native, oggvorbis, opus, sphere, w64, wavio
from .resample import design_taps, get_device_resampler, resample, resampled_length

log = logging.getLogger(__name__)

_SR = DEFAULT_CONFIG.dsp.sample_rate  # 22050
# what a corrupt or truncated file raises while it is read: every PCM
# reader's format error is a ValueError, and the codec readers raise their
# own, also where their system library is missing
_DECODE_ERRORS = (OSError, ValueError, struct.error, mp3.Mp3FormatError,
                  oggvorbis.OggFormatError, opus.OpusFormatError)


def _pcm_container_mods():
    """(is_x, info, read) per self-contained PCM container reader, checked
    after the framed codecs and before MP3: MP3's sniff could match raw PCM
    payloads, where these containers' magics are exact."""
    return (
        (w64.is_w64, w64.info, w64.read),
        (caf.is_caf, caf.info, caf.read),
        (au.is_au, au.info, au.read),
        (sphere.is_sphere, sphere.info, sphere.read),
    )


def probe(path: str):
    """Format-sniffing header probe: ``WavInfo``, ``FlacInfo`` or another
    container's or codec's info, all with samplerate / channels / frames /
    subtype / bits_per_sample / duration."""
    try:
        return wavio.info(path)
    except wavio.WavFormatError:
        if flac.is_flac(path):
            return flac.info(path)
        if aiff.is_aiff(path):
            return aiff.info(path)
        if oggvorbis.is_ogg(path):
            # Opus rides the same Ogg container: sniff the BOS packet type
            if opus.is_opus(path):
                return opus.info(path)
            return oggvorbis.info(path)
        for is_x, info_x, _read in _pcm_container_mods():
            if is_x(path):
                return info_x(path)
        if mp3.is_mp3(path):
            return mp3.info(path)
        raise


def read_any(
    path: str, start: int = 0, frames: Optional[int] = None, always_2d: bool = False
) -> Tuple[np.ndarray, int]:
    """Format-dispatching ``wavio.read``: (float32 samples, sample rate)."""
    try:
        return wavio.read(path, start=start, frames=frames, always_2d=always_2d)
    except wavio.WavFormatError:
        if flac.is_flac(path):
            return flac.read(path, start=start, frames=frames, always_2d=always_2d)
        if aiff.is_aiff(path):
            return aiff.read(path, start=start, frames=frames, always_2d=always_2d)
        if oggvorbis.is_ogg(path):
            reader = opus.read if opus.is_opus(path) else oggvorbis.read
            return reader(path, start=start, frames=frames, always_2d=always_2d)
        for is_x, _info, read_x in _pcm_container_mods():
            if is_x(path):
                return read_x(path, start=start, frames=frames, always_2d=always_2d)
        if mp3.is_mp3(path):
            return mp3.read(path, start=start, frames=frames, always_2d=always_2d)
        raise


def get_audio_data(path: str) -> Tuple[float, int]:
    """(duration_seconds, native_sample_rate) without loading samples."""
    inf = probe(path)
    return inf.duration, inf.samplerate


def to_mono(data: np.ndarray) -> np.ndarray:
    """Channel mean, like ``librosa.to_mono`` (voice_activity.py:61-62)."""
    if data.ndim > 1:
        data = data.mean(axis=-1, dtype=np.float64).astype(np.float32)
    return data


def read_mono(path: str, start: int = 0,
              frames: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """(float32 mono samples of a frame range, native sample rate).

    A PCM16 WAV decodes and downmixes in one native pass; every other
    format takes the generic decode and the channel mean.
    """
    if native.native_available():
        try:
            raw, inf = wavio.read_raw(path, start=start, frames=frames,
                                      want_subtype="PCM_16")
        except wavio.WavFormatError:
            raw = None  # not a WAV: read_any below
        if raw is not None:
            out = native.pcm16_to_mono_f32(raw.view("<i2"), inf.channels)
            if out is not None:
                return out, inf.samplerate
    data, sr = read_any(path, start=start, frames=frames)
    return to_mono(np.asarray(data, np.float32)), sr


def load_audio(
    path: str, start: Optional[int] = None, target_sr: int = _SR
) -> Tuple[Optional[np.ndarray], Optional[int]]:
    """Load a file (or a 3 s slice at internal-rate sample offset ``start``),
    downmix to mono and resample to ``target_sr``.

    ``start`` is in internal-rate samples, translated to the native rate as
    the reference does (voice_activity.py:47-48).  A corrupt file, or one
    whose codec library does not load, gives ``(None, None)``
    (voice_activity.py:40-41).
    """
    try:
        if start is None:
            data, sr = read_mono(path)
        else:
            sr = probe(path).samplerate
            data, sr = read_mono(path, start=int(start * (sr / target_sr)),
                                 frames=int(sr * 3))
    except _DECODE_ERRORS as e:
        log.error("failed to read %s: %s", path, e)
        return None, None
    if sr != target_sr:
        data = resample(data, sr, target_sr)
        sr = target_sr
    return data, sr


def load_audio_startstop(
    path: str, start_stop: Tuple[float, float], target_sr: int = _SR
) -> Tuple[Optional[np.ndarray], Optional[int]]:
    """Load ``[start, stop)`` seconds; clamps stop at EOF; mono + resample."""
    start, stop = start_stop
    if start < 0 or stop <= start:
        log.error("invalid start/stop (%s, %s)", start, stop)
        return None, None
    try:
        inf = probe(path)
        read_start = int(start * inf.samplerate)
        read_stop = min(int(stop * inf.samplerate), inf.frames)
        data, sr = read_any(path, start=read_start, frames=read_stop - read_start)
    except _DECODE_ERRORS as e:
        log.error("failed to read %s: %s", path, e)
        return None, None
    if data.size == 0:
        return None, None
    data = to_mono(np.asarray(data, np.float32))
    if sr != target_sr:
        data = resample(data, sr, target_sr)
        sr = target_sr
    return data, sr


@dataclass(frozen=True)
class AudioChunk:
    """A contiguous run of internal-rate samples from one file."""

    data: np.ndarray       # float32 mono at target_sr
    start_sample: int      # offset of data[0] in the full internal-rate stream
    total_samples: int     # full internal-rate length of the file
    is_last: bool


def internal_length(path: str, target_sr: int = _SR) -> int:
    """Length of the file after downmix + resample, without decoding."""
    inf = probe(path)
    return resampled_length(inf.frames, inf.samplerate, target_sr)


def stream_chunks(
    path: str,
    chunk_samples: int,
    target_sr: int = _SR,
    backend: str = "host",
    device=None,
) -> Iterator[AudioChunk]:
    """Yield the file as bounded-size internal-rate chunks.

    Each chunk resamples a native range with the filter's context on both
    sides, so the chunks concatenated reproduce ``load_audio`` to float
    round-off.  ``backend``: "host" (native/scipy polyphase) or "device"
    (one polyphase GEMM per chunk on ``device``, default the CUDA card).
    One persistent reader serves the whole file: FLAC's sequential decoder
    (FLAC has no byte index, so a reopen would decode from the start), an
    MP3 handle (a per-range read would re-scan the whole file), an Opus
    forward-only handle (a per-range read would re-enter with pre-roll and
    lose bit-exactness at the seams), or a PCM16 WAV handle with readahead
    hints; each is closed when the generator ends or is dropped.
    """
    if backend not in ("host", "device"):
        raise ValueError(f"unknown resample backend {backend!r}")
    inf = probe(path)
    sr = inf.samplerate
    total = resampled_length(inf.frames, sr, target_sr)
    handle = None
    if inf.subtype.startswith("FLAC"):
        handle = flac.SequentialMonoReader(path)
        read_native = handle.read
    elif inf.subtype.startswith("MPEG"):
        handle = mp3.SequentialMonoReader(path)
        read_native = handle.read
    elif inf.subtype == "OPUS":
        handle = opus.SequentialMonoReader(path)
        read_native = handle.read
    elif isinstance(inf, wavio.WavInfo) and inf.subtype == "PCM_16":
        handle = wavio.RawReader(path)

        def read_native(start: int, frames: int) -> np.ndarray:
            handle.will_need(start + frames, frames)  # prefetch the next range
            raw = handle.read_raw(start, frames).view("<i2")
            out = native.pcm16_to_mono_f32(raw, inf.channels)
            if out is not None:
                return out
            return to_mono(raw.reshape(-1, inf.channels).astype(np.float32) / 32768.0)
    else:
        def read_native(start: int, frames: int) -> np.ndarray:
            return read_mono(path, start=start, frames=frames)[0]

    try:
        yield from _stream_chunks_impl(read_native, inf.frames, sr, total,
                                       chunk_samples, target_sr, backend, device)
    finally:
        if handle is not None:
            handle.close()


def _stream_chunks_impl(
    read_native: Callable[[int, int], np.ndarray], native_frames: int, sr: int,
    total_internal: int, chunk_samples: int, target_sr: int, backend: str, device,
) -> Iterator[AudioChunk]:
    if sr == target_sr:
        pos = 0
        while pos < native_frames:
            n = min(chunk_samples, native_frames - pos)
            yield AudioChunk(read_native(pos, n), pos, total_internal,
                             pos + n >= native_frames)
            pos += n
        return

    if backend == "device":
        dev = torch.device(device) if device is not None else torch.device("cuda")
        rs_dev = get_device_resampler(sr, target_sr, chunk_samples, dev)
        out_pos = 0
        while out_pos < total_internal:
            out_n = min(chunk_samples, total_internal - out_pos)
            data = rs_dev.resample_range(read_native, native_frames, out_pos, out_n)
            yield AudioChunk(data, out_pos, total_internal,
                             out_pos + out_n >= total_internal)
            out_pos += out_n
        return

    g = math.gcd(sr, target_sr)
    up, down = target_sr // g, sr // g
    # native-rate context so that edge outputs see the full filter support
    context = -(-(len(design_taps(up, down)) // 2) // up) + 8
    out_pos = 0
    while out_pos < total_internal:
        out_n = min(chunk_samples, total_internal - out_pos)
        # native range whose resampled image covers [out_pos, out_pos+out_n)
        in_first = (out_pos * down) // up
        in_last = -(-((out_pos + out_n) * down) // up)
        rs = max(0, in_first - context)
        rs -= rs % down  # snap to the output grid: res[k] is global rs·up/down + k
        re = min(native_frames, in_last + context)
        res = resample(read_native(rs, re - rs), sr, target_sr)
        lo = out_pos - (rs * up) // down
        yield AudioChunk(res[lo: lo + out_n], out_pos, total_internal,
                         out_pos + out_n >= total_internal)
        out_pos += out_n
