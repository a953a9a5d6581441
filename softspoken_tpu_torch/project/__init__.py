"""Detections storage."""

from .store import COLUMNS, DetectionStore

__all__ = ["COLUMNS", "DetectionStore"]
