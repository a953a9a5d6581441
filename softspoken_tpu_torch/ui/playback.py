"""Audio playback for review (headless-friendly).

A copy of the JAX package's ``ui/playback.py``.

The reference plays a detection by writing the segment to a temp WAV and
handing it to QMediaPlayer (review_detections.py:466-536).  Here the same
flow is a plain helper: materialize the segment WAV (usable by any player)
and, when a playback backend is importable (``sounddevice``), play it
directly.  Neither Qt nor sounddevice is required for the rest of the
framework.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Tuple

import numpy as np

from ..config import Config, DEFAULT_CONFIG
from ..io import load_audio_startstop, wavio


def export_segment_wav(
    full_path: str,
    start_stop: Tuple[float, float],
    out_path: Optional[str] = None,
    config: Config = DEFAULT_CONFIG,
) -> str:
    """Write [start, stop) seconds of a recording to a WAV; returns its path.

    Starts are clamped to 0 — detection times can be negative (the −3 s pad
    shift, worker.py:100), and the render path clamps the same way
    (review_detections.py:848).
    """
    start_stop = (max(0.0, float(start_stop[0])), float(start_stop[1]))
    data, sr = load_audio_startstop(full_path, start_stop, target_sr=config.dsp.sample_rate)
    if data is None:
        raise IOError(f"failed to load {full_path} {start_stop}")
    if out_path is None:
        fd, out_path = tempfile.mkstemp(suffix=".wav", prefix="softspoken_play_")
        os.close(fd)
    wavio.write(out_path, np.asarray(data, np.float32), sr, subtype="PCM_16")
    return out_path


def stop_playback() -> bool:
    """Stop any in-progress non-blocking playback (the reference's Stop
    button, review_detections.py:466-536); False if no backend exists."""
    try:
        import sounddevice as sd  # optional dependency, absent in CI
    except Exception:  # noqa: BLE001
        return False
    sd.stop()
    return True


def play_segment(full_path: str, start_stop: Tuple[float, float],
                 config: Config = DEFAULT_CONFIG, blocking: bool = True) -> bool:
    """Play a segment if a playback backend exists; returns False otherwise.

    Clamps negative starts like ``export_segment_wav`` (detection times can
    be negative after the −3 s pad shift) so callers can pass row times raw.
    """
    try:
        import sounddevice as sd  # optional dependency, absent in CI
    except Exception:  # noqa: BLE001
        return False
    start_stop = (max(0.0, float(start_stop[0])), float(start_stop[1]))
    data, sr = load_audio_startstop(full_path, start_stop, target_sr=config.dsp.sample_rate)
    if data is None:
        return False
    sd.play(data, sr)
    if blocking:
        sd.wait()
    return True
