"""The detector and its fused streaming engine."""

from .detector import DetectionResult, Detector

__all__ = ["DetectionResult", "Detector"]
