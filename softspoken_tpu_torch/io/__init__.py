"""Audio input: the WAV reader and the polyphase resampler."""

from typing import Tuple

from . import wavio
from .wavio import probe

__all__ = ["wavio", "probe", "get_audio_data"]


def get_audio_data(path: str) -> Tuple[float, int]:
    """(duration_seconds, native_sample_rate) without loading samples."""
    inf = probe(path)
    return inf.duration, inf.samplerate
