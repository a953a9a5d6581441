"""Headless PySide6 stand-in (see softspoken_tpu_torch.ui.qt_shim)."""

__softspoken_shim__ = True
__version__ = "0.0-shim"

from . import QtCore, QtGui, QtWidgets  # noqa: E402,F401
