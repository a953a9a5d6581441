"""QtGui subset: QPixmap, QImage, QAction, QKeySequence, QColor, QBrush."""

from __future__ import annotations

from .QtCore import QObject, QSize, Signal


class QColor:
    def __init__(self, r: int = 0, g: int = 0, b: int = 0, a: int = 255):
        self.r, self.g, self.b, self.a = r, g, b, a

    def name(self) -> str:
        return f"#{self.r:02x}{self.g:02x}{self.b:02x}"

    def __eq__(self, other):
        return isinstance(other, QColor) and (
            (self.r, self.g, self.b, self.a) == (other.r, other.g, other.b, other.a)
        )

    def __repr__(self):
        return f"QColor({self.r}, {self.g}, {self.b})"


class QBrush:
    def __init__(self, color: QColor = None):
        self._color = color or QColor()

    def color(self) -> QColor:
        return self._color


class QPixmap:
    """Stores the PNG bytes it was loaded from (enough to assert the review
    screen really rendered a spectrogram)."""

    def __init__(self, w: int = 0, h: int = 0):
        self._size = QSize(w, h)
        self.data = b""

    def loadFromData(self, data: bytes, fmt: str = None) -> bool:
        self.data = bytes(data)
        if self.data[:8] == b"\x89PNG\r\n\x1a\n":
            # pull the true size from the IHDR chunk
            import struct

            w, h = struct.unpack(">II", self.data[16:24])
            self._size = QSize(w, h)
        return bool(self.data)

    def isNull(self) -> bool:
        return not self.data and self._size == QSize(0, 0)

    def size(self) -> QSize:
        return self._size

    def width(self) -> int:
        return self._size.width()

    def height(self) -> int:
        return self._size.height()

    def scaled(self, *args, **kw) -> "QPixmap":
        return self

    def save(self, path: str, fmt: str = None) -> bool:
        with open(path, "wb") as f:
            f.write(self.data)
        return True


class QImage(QPixmap):
    pass


class QKeySequence:
    def __init__(self, key: str = ""):
        self._key = key

    def toString(self) -> str:
        return self._key


class QAction(QObject):
    triggered = Signal(bool)

    def __init__(self, text: str = "", parent=None):
        super().__init__(parent)
        self._text = text
        self._shortcut = None

    def text(self) -> str:
        return self._text

    def setShortcut(self, seq) -> None:
        self._shortcut = seq

    def shortcut(self):
        return self._shortcut

    def trigger(self) -> None:
        self.triggered.emit(False)
