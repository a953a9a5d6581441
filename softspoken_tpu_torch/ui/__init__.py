"""The headless review: session, spectrogram PNG, segment playback."""

from .playback import export_segment_wav, play_segment
from .review import ReviewSession
from .spectrogram import (
    amplitude_to_db,
    display_spec,
    plan_view_window,
    render_review_png,
)

__all__ = [
    "ReviewSession",
    "display_spec",
    "amplitude_to_db",
    "plan_view_window",
    "render_review_png",
    "export_segment_wav",
    "play_segment",
]
