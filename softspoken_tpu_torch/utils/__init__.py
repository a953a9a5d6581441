from .logging import JsonFormatter, setup_logging

__all__ = ["setup_logging", "JsonFormatter"]
