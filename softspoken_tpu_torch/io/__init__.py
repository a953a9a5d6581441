"""Audio input: the WAV reader, loading and streaming, and the resampler."""

from . import wavio
from .audio import (
    AudioChunk,
    get_audio_data,
    internal_length,
    load_audio,
    load_audio_startstop,
    read_mono,
    stream_chunks,
    to_mono,
)
from .resample import resample, resampled_length
from .wavio import probe

__all__ = [
    "wavio", "probe", "AudioChunk", "get_audio_data", "internal_length",
    "load_audio", "load_audio_startstop", "read_mono", "stream_chunks",
    "to_mono", "resample", "resampled_length",
]
