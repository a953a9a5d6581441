"""Audio loading with the reference's semantics, over the port's WAV reader.

Mirrors the behaviour (not the implementation) of the reference's
``root/code/backend/voice_activity.py`` and the JAX package's
``io/audio.py``:

  * ``get_audio_data``        — voice_activity.py:23-30 (header-only probe)
  * ``load_audio``            — voice_activity.py:32-69 (whole file or a 3 s
                                slice, channel-mean downmix, resample to
                                22050 Hz, (None, None) on a decode failure)
  * ``load_audio_startstop``  — voice_activity.py:72-143 (a seconds range,
                                stop clamped at EOF)
  * ``stream_chunks``         — bounded-memory internal-rate chunks for
                                multi-hour recordings (the host pipeline's
                                streaming decode)

WAV only (``io/wavio.py``): FLAC, MP3, Ogg, Opus, AIFF and the other
containers raise ``NotImplementedError`` naming the format, since their
readers are a later slice of the port.
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
from . import wavio
from .resample import design_taps, get_device_resampler, resample, resampled_length

log = logging.getLogger(__name__)

_SR = DEFAULT_CONFIG.dsp.sample_rate  # 22050
# what a corrupt or truncated WAV raises while it is read
_DECODE_ERRORS = (OSError, ValueError, struct.error)


def get_audio_data(path: str) -> Tuple[float, int]:
    """(duration_seconds, native_sample_rate) without loading samples."""
    inf = wavio.probe(path)
    return inf.duration, inf.samplerate


def to_mono(data: np.ndarray) -> np.ndarray:
    """Channel mean, like ``librosa.to_mono`` (voice_activity.py:61-62)."""
    if data.ndim > 1:
        data = data.mean(axis=-1, dtype=np.float64).astype(np.float32)
    return data


def read_mono(path: str, start: int = 0,
              frames: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """(float32 mono samples of a frame range, native sample rate)."""
    with wavio.RawReader(path) as r:
        n = r.info.frames - start if frames is None else frames
        return r.read_mono_f32(start, n), r.info.samplerate


def load_audio(
    path: str, start: Optional[int] = None, target_sr: int = _SR
) -> Tuple[Optional[np.ndarray], Optional[int]]:
    """Load a file (or a 3 s slice at internal-rate sample offset ``start``),
    downmix to mono and resample to ``target_sr``.

    ``start`` is in internal-rate samples, translated to the native rate as
    the reference does (voice_activity.py:47-48).  A corrupt file gives
    ``(None, None)`` (voice_activity.py:40-41); a format whose reader is not
    ported raises ``NotImplementedError``.
    """
    try:
        if start is None:
            data, sr = read_mono(path)
        else:
            sr = wavio.probe(path).samplerate
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
        inf = wavio.probe(path)
        read_start = int(start * inf.samplerate)
        read_stop = min(int(stop * inf.samplerate), inf.frames)
        data, sr = read_mono(path, start=read_start, frames=read_stop - read_start)
    except _DECODE_ERRORS as e:
        log.error("failed to read %s: %s", path, e)
        return None, None
    if data.size == 0:
        return None, None
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
    inf = wavio.probe(path)
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
    round-off.  ``backend``: "host" (scipy polyphase) or "device" (one
    polyphase GEMM per chunk on ``device``, default the CUDA card).  One
    file handle, with sequential readahead hints, serves the whole file and
    is closed when the generator ends or is dropped.
    """
    if backend not in ("host", "device"):
        raise ValueError(f"unknown resample backend {backend!r}")
    with wavio.RawReader(path) as reader:
        inf = reader.info

        def read_native(start: int, frames: int) -> np.ndarray:
            reader.will_need(start + frames, frames)  # prefetch the next range
            return reader.read_mono_f32(start, frames)

        total = resampled_length(inf.frames, inf.samplerate, target_sr)
        yield from _stream_chunks_impl(read_native, inf.frames, inf.samplerate, total,
                                       chunk_samples, target_sr, backend, device)


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
