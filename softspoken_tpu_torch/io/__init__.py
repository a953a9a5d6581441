"""Audio input: the readers (WAV/RF64/RIFX, FLAC, AIFF, W64, CAF, AU,
SPHERE), loading and streaming, the native host DSP and the resampler."""

from . import wavio
from .audio import (
    AudioChunk,
    get_audio_data,
    internal_length,
    load_audio,
    load_audio_startstop,
    probe,
    read_any,
    read_mono,
    stream_chunks,
    to_mono,
)
from .resample import resample, resampled_length

__all__ = [
    "wavio", "probe", "read_any", "AudioChunk", "get_audio_data",
    "internal_length", "load_audio", "load_audio_startstop", "read_mono",
    "stream_chunks", "to_mono", "resample", "resampled_length",
]
