"""Review exporters: Audacity labels, Kaleidoscope CSV, Raven selection table."""

from .audacity import AudacityTxtTransform
from .base import ReviewExportManager, Transform, run_standard_exports, standard_manager
from .kaleidoscope import KaleidoscopeCsvTransform
from .raven import RavenTxtTransform

__all__ = [
    "Transform",
    "ReviewExportManager",
    "standard_manager",
    "run_standard_exports",
    "AudacityTxtTransform",
    "KaleidoscopeCsvTransform",
    "RavenTxtTransform",
]
