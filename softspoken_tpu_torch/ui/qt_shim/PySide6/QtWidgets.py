"""QtWidgets subset: the widget tree, layouts, table/list widgets, dialogs.

State is plain Python; static dialogs return inert defaults so tests can
monkeypatch them (``QFileDialog.getOpenFileNames = lambda *a: (paths, "")``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from .QtCore import QObject, QSize, Qt, Signal
from .QtGui import QBrush, QColor, QKeySequence, QPixmap


# ---------------------------------------------------------------------------
# base widget + layouts
# ---------------------------------------------------------------------------

class QWidget(QObject):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._layout = None
        self._visible = False
        self._enabled = True
        self._size = QSize(1100, 720)
        self._title = ""
        self._tooltip = ""

    # geometry
    def resize(self, w: int, h: int) -> None:
        self._size = QSize(w, h)

    def size(self) -> QSize:
        return self._size

    def width(self) -> int:
        return self._size.width()

    def height(self) -> int:
        return self._size.height()

    def setMinimumHeight(self, h: int) -> None:
        pass

    def setMinimumWidth(self, w: int) -> None:
        pass

    def setMaximumWidth(self, w: int) -> None:
        pass

    # visibility / state
    def show(self) -> None:
        self._visible = True

    def hide(self) -> None:
        self._visible = False

    def isVisible(self) -> bool:
        return self._visible

    def close(self) -> bool:
        self._visible = False
        return True

    def setEnabled(self, e: bool) -> None:
        self._enabled = bool(e)

    def isEnabled(self) -> bool:
        return self._enabled

    # misc
    def setWindowTitle(self, t: str) -> None:
        self._title = t

    def windowTitle(self) -> str:
        return self._title

    def setLayout(self, lay) -> None:
        self._layout = lay

    def layout(self):
        return self._layout

    def setToolTip(self, t: str) -> None:
        self._tooltip = t

    def setStyleSheet(self, s: str) -> None:
        pass

    def setFocus(self) -> None:
        pass

    def update(self) -> None:
        pass


class _Layout:
    def __init__(self, parent: QWidget = None):
        self.items: List[object] = []
        if parent is not None:
            parent.setLayout(self)

    def addWidget(self, w, *args, **kw) -> None:
        self.items.append(w)

    def addLayout(self, lay, *args, **kw) -> None:
        self.items.append(lay)

    def addStretch(self, n: int = 0) -> None:
        pass

    def addRow(self, label, widget=None) -> None:  # QFormLayout
        self.items.append((label, widget))

    def count(self) -> int:
        return len(self.items)


class QVBoxLayout(_Layout):
    pass


class QHBoxLayout(_Layout):
    pass


class QFormLayout(_Layout):
    pass


class QGridLayout(_Layout):
    pass


# ---------------------------------------------------------------------------
# simple widgets
# ---------------------------------------------------------------------------

class QLabel(QWidget):
    def __init__(self, text: str = "", parent=None):
        super().__init__(parent)
        self._text = text
        self._pixmap: Optional[QPixmap] = None

    def setText(self, t: str) -> None:
        self._text = str(t)
        self._pixmap = None

    def text(self) -> str:
        return self._text

    def setPixmap(self, p: QPixmap) -> None:
        self._pixmap = p

    def pixmap(self) -> Optional[QPixmap]:
        return self._pixmap

    def setWordWrap(self, w: bool) -> None:
        pass

    def setAlignment(self, a) -> None:
        pass


class QPushButton(QWidget):
    clicked = Signal(bool)

    def __init__(self, text: str = "", parent=None):
        super().__init__(parent)
        self._text = text
        self._shortcut = None

    def text(self) -> str:
        return self._text

    def setText(self, t: str) -> None:
        self._text = t

    def setShortcut(self, seq) -> None:
        self._shortcut = seq

    def click(self) -> None:
        if self._enabled:
            self.clicked.emit(False)


class QProgressBar(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._value = 0

    def setValue(self, v: int) -> None:
        self._value = int(v)

    def value(self) -> int:
        return self._value

    def setRange(self, lo: int, hi: int) -> None:
        pass


class QLineEdit(QWidget):
    textChanged = Signal(str)

    def __init__(self, text: str = "", parent=None):
        super().__init__(parent)
        self._text = text

    def text(self) -> str:
        return self._text

    def setText(self, t: str) -> None:
        self._text = str(t)
        self.textChanged.emit(self._text)

    def setPlaceholderText(self, t: str) -> None:
        pass


class QComboBox(QWidget):
    currentTextChanged = Signal(str)

    def __init__(self, parent=None):
        super().__init__(parent)
        self._items: List[str] = []
        self._index = -1

    def addItems(self, items) -> None:
        self._items.extend(items)
        if self._index < 0 and self._items:
            self._index = 0

    def currentText(self) -> str:
        return self._items[self._index] if 0 <= self._index < len(self._items) else ""

    def setCurrentText(self, t: str) -> None:
        if t in self._items:
            self._index = self._items.index(t)
            self.currentTextChanged.emit(t)


class QCheckBox(QWidget):
    toggled = Signal(bool)

    def __init__(self, text: str = "", parent=None):
        super().__init__(parent)
        self._text = text
        self._checked = False

    def setChecked(self, c: bool) -> None:
        self._checked = bool(c)
        self.toggled.emit(self._checked)

    def isChecked(self) -> bool:
        return self._checked


# ---------------------------------------------------------------------------
# list / table
# ---------------------------------------------------------------------------

class QListWidgetItem:
    def __init__(self, text: str = ""):
        self._text = text

    def text(self) -> str:
        return self._text


class QListWidget(QWidget):
    itemSelectionChanged = Signal()

    def __init__(self, parent=None):
        super().__init__(parent)
        self._items: List[QListWidgetItem] = []
        self._selected: List[int] = []

    def addItems(self, texts) -> None:
        self._items.extend(QListWidgetItem(t) for t in texts)

    def addItem(self, text) -> None:
        self._items.append(
            text if isinstance(text, QListWidgetItem) else QListWidgetItem(text)
        )

    def clear(self) -> None:
        self._items.clear()
        self._selected.clear()

    def count(self) -> int:
        return len(self._items)

    def item(self, i: int) -> QListWidgetItem:
        return self._items[i]

    def setSelectionMode(self, m) -> None:
        pass

    def selectedItems(self) -> List[QListWidgetItem]:
        return [self._items[i] for i in self._selected]

    def setCurrentRow(self, r: int) -> None:
        self._selected = [r] if 0 <= r < len(self._items) else []
        self.itemSelectionChanged.emit()

    # test helper mirroring user multi-select
    def shim_selectRows(self, rows) -> None:
        # test-only helper (NOT real PySide6 API — hence the shim_ prefix,
        # enforced by tests/test_shim_fidelity.py)
        self._selected = [r for r in rows if 0 <= r < len(self._items)]
        self.itemSelectionChanged.emit()


class QTableWidgetItem:
    def __init__(self, text: str = ""):
        self._text = str(text)
        self._background = QBrush(QColor(255, 255, 255))
        self._flags = (
            Qt.ItemFlag.ItemIsSelectable
            | Qt.ItemFlag.ItemIsEditable
            | Qt.ItemFlag.ItemIsEnabled
        )
        self._table: Optional["QTableWidget"] = None

    def text(self) -> str:
        return self._text

    def setText(self, t: str) -> None:
        self._text = str(t)
        if self._table is not None and not self._table.signalsBlocked():
            self._table.itemChanged.emit(self)

    def setBackground(self, b) -> None:
        self._background = b if isinstance(b, QBrush) else QBrush(b)

    def background(self) -> QBrush:
        return self._background

    def setFlags(self, f) -> None:
        self._flags = f

    def flags(self):
        return self._flags

    def row(self) -> int:
        if self._table is None:
            return -1
        for (r, c), it in self._table._items.items():
            if it is self:
                return r
        return -1

    def column(self) -> int:
        if self._table is None:
            return -1
        for (r, c), it in self._table._items.items():
            if it is self:
                return c
        return -1


class QTableWidget(QWidget):
    itemSelectionChanged = Signal()
    itemChanged = Signal(object)
    cellDoubleClicked = Signal(int, int)

    def __init__(self, rows: int = 0, cols: int = 0, parent=None):
        super().__init__(parent)
        self._rows, self._cols = rows, cols
        self._items: Dict[Tuple[int, int], QTableWidgetItem] = {}
        self._headers: List[str] = []
        self._current = (-1, -1)

    def clear(self) -> None:
        self._items.clear()
        self._headers = []
        self._current = (-1, -1)

    def setRowCount(self, r: int) -> None:
        self._rows = r

    def rowCount(self) -> int:
        return self._rows

    def setColumnCount(self, c: int) -> None:
        self._cols = c

    def columnCount(self) -> int:
        return self._cols

    def setHorizontalHeaderLabels(self, labels) -> None:
        self._headers = list(labels)

    def shim_horizontalHeaderLabels(self) -> List[str]:
        # test-only helper (NOT real PySide6 API)
        return list(self._headers)

    def setItem(self, r: int, c: int, item: QTableWidgetItem) -> None:
        item._table = self
        self._items[(r, c)] = item

    def item(self, r: int, c: int) -> Optional[QTableWidgetItem]:
        return self._items.get((r, c))

    def selectRow(self, r: int) -> None:
        self._current = (r, 0)
        self.itemSelectionChanged.emit()

    def setCurrentCell(self, r: int, c: int) -> None:
        self._current = (r, c)
        self.itemSelectionChanged.emit()

    def currentRow(self) -> int:
        return self._current[0]

    def currentColumn(self) -> int:
        return self._current[1]

    def setSortingEnabled(self, e: bool) -> None:
        pass

    def resizeColumnsToContents(self) -> None:
        pass

    def setEditTriggers(self, t) -> None:
        pass


# ---------------------------------------------------------------------------
# containers / windows / menus
# ---------------------------------------------------------------------------

class QStackedWidget(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._widgets: List[QWidget] = []
        self._current: Optional[QWidget] = None

    def addWidget(self, w: QWidget) -> None:
        self._widgets.append(w)
        if self._current is None:
            self._current = w

    def setCurrentWidget(self, w: QWidget) -> None:
        assert w in self._widgets, "widget not in stack"
        self._current = w

    def currentWidget(self) -> Optional[QWidget]:
        return self._current


class QMenu(QObject):
    def __init__(self, title: str = "", parent=None):
        super().__init__(parent)
        self._title = title
        self._actions = []

    def addAction(self, action) -> None:
        self._actions.append(action)

    def actions(self):
        return list(self._actions)


class QMenuBar(QObject):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._menus: List[QMenu] = []

    def addMenu(self, title: str) -> QMenu:
        m = QMenu(title)
        self._menus.append(m)
        return m

    def shim_menus(self) -> List[QMenu]:
        # test-only helper (NOT real PySide6 API)
        return list(self._menus)


class QMainWindow(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._menubar = QMenuBar(self)
        self._central: Optional[QWidget] = None

    def menuBar(self) -> QMenuBar:
        return self._menubar

    def setCentralWidget(self, w: QWidget) -> None:
        self._central = w

    def centralWidget(self) -> Optional[QWidget]:
        return self._central


class QSplitter(QWidget):
    splitterMoved = Signal(int, int)

    def __init__(self, orientation=None, parent=None):
        super().__init__(parent)
        self._widgets: List[QWidget] = []

    def addWidget(self, w: QWidget) -> None:
        self._widgets.append(w)

    def setSizes(self, sizes) -> None:
        pass


# ---------------------------------------------------------------------------
# dialogs
# ---------------------------------------------------------------------------

class QDialog(QWidget):
    class DialogCode:
        Rejected = 0
        Accepted = 1

    Accepted = 1
    Rejected = 0

    def __init__(self, parent=None):
        super().__init__(parent)
        self._result = QDialog.Rejected

    def accept(self) -> None:
        self._result = QDialog.Accepted
        self._visible = False

    def reject(self) -> None:
        self._result = QDialog.Rejected
        self._visible = False

    def exec(self) -> int:
        """Headless: returns the pre-set result (tests fill the fields and
        call accept() first, or monkeypatch exec)."""
        return self._result

    def result(self) -> int:
        return self._result


class QFileDialog:
    @staticmethod
    def getOpenFileNames(parent=None, caption="", directory="", filter="") -> Tuple[List[str], str]:
        return [], ""

    @staticmethod
    def getOpenFileName(parent=None, caption="", directory="", filter="") -> Tuple[str, str]:
        return "", ""

    @staticmethod
    def getExistingDirectory(parent=None, caption="", directory="") -> str:
        return ""

    @staticmethod
    def getSaveFileName(parent=None, caption="", directory="", filter="") -> Tuple[str, str]:
        return "", ""


class QInputDialog:
    @staticmethod
    def getText(parent=None, title="", label="", *a, **kw) -> Tuple[str, bool]:
        return "", False

    @staticmethod
    def getItem(parent=None, title="", label="", items=(), current=0, editable=True) -> Tuple[str, bool]:
        return (items[current] if items else ""), False

    @staticmethod
    def getDouble(parent=None, title="", label="", value=0.0, *a, **kw) -> Tuple[float, bool]:
        return value, False


class QMessageBox(QObject):
    class StandardButton:
        Yes = 0x4000
        No = 0x10000
        Ok = 0x400
        Cancel = 0x400000

    #: override in tests to steer confirmations
    _question_answer = StandardButton.Yes
    #: record of (kind, title, text) for assertions
    _log: List[Tuple[str, str, str]] = []

    @classmethod
    def question(cls, parent=None, title="", text="", *a, **kw):
        cls._log.append(("question", title, text))
        return cls._question_answer

    @classmethod
    def information(cls, parent=None, title="", text="", *a, **kw):
        cls._log.append(("information", title, text))
        return cls.StandardButton.Ok

    @classmethod
    def warning(cls, parent=None, title="", text="", *a, **kw):
        cls._log.append(("warning", title, text))
        return cls.StandardButton.Ok

    @classmethod
    def critical(cls, parent=None, title="", text="", *a, **kw):
        cls._log.append(("critical", title, text))
        return cls.StandardButton.Ok


# ---------------------------------------------------------------------------
# application
# ---------------------------------------------------------------------------

class QApplication(QObject):
    _instance = None

    def __init__(self, argv=None):
        super().__init__()
        QApplication._instance = self
        self._style = ""

    @staticmethod
    def instance() -> Optional["QApplication"]:
        return QApplication._instance

    def setStyleSheet(self, s: str) -> None:
        self._style = s

    def exec(self) -> int:
        return 0

    @staticmethod
    def processEvents() -> None:
        pass

    def quit(self) -> None:
        pass
