"""The silence step: mute the erased intervals, write *_silenced.wav."""

from .silencer import STATUS_FILENAME, SilenceReport, SilenceRunner, write_status_file

__all__ = ["SilenceRunner", "SilenceReport", "write_status_file", "STATUS_FILENAME"]
