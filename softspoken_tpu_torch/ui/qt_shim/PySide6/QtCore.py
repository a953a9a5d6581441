"""QtCore subset: QObject, Signal/Slot, Qt namespace, QTimer, QThreadPool,
QSize. Synchronous, deterministic semantics (see package docstring)."""

from __future__ import annotations

from enum import IntEnum, IntFlag
from typing import Any, Callable, List


class _BoundSignal:
    def __init__(self, name: str):
        self._name = name
        self._slots: List[Callable] = []

    def connect(self, slot: Callable) -> None:
        self._slots.append(slot)

    def disconnect(self, slot: Callable = None) -> None:
        if slot is None:
            self._slots.clear()
        else:
            self._slots.remove(slot)

    def emit(self, *args: Any) -> None:
        for slot in list(self._slots):
            slot(*_trim_args(slot, args))


def _trim_args(slot: Callable, args: tuple) -> tuple:
    """Qt delivers only as many signal arguments as the slot accepts."""
    import inspect

    try:
        sig = inspect.signature(slot)
    except (TypeError, ValueError):
        return args
    n = 0
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            n += 1
        elif p.kind == p.VAR_POSITIONAL:
            return args
    return args[:n]


class Signal:
    """Class-attribute descriptor → per-instance bound signal (Qt model)."""

    def __init__(self, *types: Any):
        self.types = types
        self.name = "<anon>"

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        store = obj.__dict__.setdefault("__signals__", {})
        if self.name not in store:
            store[self.name] = _BoundSignal(self.name)
        return store[self.name]


def Slot(*args, **kw):
    """Decorator no-op (slot registration is a Qt moc concern)."""

    def deco(fn):
        return fn

    return deco


class QObject:
    def __init__(self, parent: "QObject" = None):
        self._parent = parent

    def parent(self):
        return self._parent

    def deleteLater(self):
        pass

    def blockSignals(self, blocked: bool) -> bool:
        prev = getattr(self, "_signals_blocked", False)
        self._signals_blocked = bool(blocked)
        return prev

    def signalsBlocked(self) -> bool:
        return getattr(self, "_signals_blocked", False)


class QSize:
    def __init__(self, w: int = 0, h: int = 0):
        self._w, self._h = int(w), int(h)

    def width(self) -> int:
        return self._w

    def height(self) -> int:
        return self._h

    def __eq__(self, other):
        return isinstance(other, QSize) and (self._w, self._h) == (other._w, other._h)

    def __repr__(self):
        return f"QSize({self._w}, {self._h})"


class Qt:
    class AlignmentFlag(IntFlag):
        AlignLeft = 0x1
        AlignRight = 0x2
        AlignHCenter = 0x4
        AlignTop = 0x20
        AlignBottom = 0x40
        AlignVCenter = 0x80
        AlignCenter = 0x84

    class AspectRatioMode(IntEnum):
        IgnoreAspectRatio = 0
        KeepAspectRatio = 1
        KeepAspectRatioByExpanding = 2

    class ItemFlag(IntFlag):
        NoItemFlags = 0
        ItemIsSelectable = 1
        ItemIsEditable = 2
        ItemIsEnabled = 32

    class ItemDataRole(IntEnum):
        DisplayRole = 0
        BackgroundRole = 8

    class Orientation(IntEnum):
        Horizontal = 1
        Vertical = 2

    # commonly referenced aliases
    AlignCenter = AlignmentFlag.AlignCenter
    KeepAspectRatio = AspectRatioMode.KeepAspectRatio


class QTimer(QObject):
    """Deterministic timer: ``start`` fires ``timeout`` immediately, so
    debounced operations run exactly once per trigger in tests."""

    timeout = Signal()

    def __init__(self, parent=None):
        super().__init__(parent)
        self._single = False
        self._active = False
        self._interval = 0

    def setSingleShot(self, s: bool) -> None:
        self._single = bool(s)

    def isSingleShot(self) -> bool:
        return self._single

    def setInterval(self, ms: int) -> None:
        self._interval = int(ms)

    def interval(self) -> int:
        return self._interval

    def isActive(self) -> bool:
        return self._active

    def start(self, ms: int = None) -> None:
        if ms is not None:
            self._interval = int(ms)
        self._active = not self._single
        self.timeout.emit()

    def stop(self) -> None:
        self._active = False

    @staticmethod
    def singleShot(ms: int, slot: Callable) -> None:
        slot()


class QRunnable:
    def __init__(self):
        self._auto_delete = True

    def run(self):  # pragma: no cover — overridden
        pass

    def setAutoDelete(self, v: bool) -> None:
        self._auto_delete = bool(v)


class QThreadPool(QObject):
    """Synchronous pool: ``start`` runs the runnable inline, so worker
    lifecycles are deterministic under test."""

    _global = None

    @staticmethod
    def globalInstance() -> "QThreadPool":
        if QThreadPool._global is None:
            QThreadPool._global = QThreadPool()
        return QThreadPool._global

    def start(self, runnable: QRunnable) -> None:
        runnable.run()

    def waitForDone(self, ms: int = -1) -> bool:
        return True


class QUrl:
    def __init__(self, url: str = ""):
        self._url = url

    @staticmethod
    def fromLocalFile(path: str) -> "QUrl":
        return QUrl("file://" + path)

    def toString(self) -> str:
        return self._url
