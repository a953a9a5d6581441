"""Qt desktop shell (optional — requires PySide6, or the headless shim).

The reference is a PySide6 desktop app (``silencer_ui.py``,
``review_detections.py``); this module provides the same four-screen flow —
Home → project workspace → Voice Detector / Review / Silence — as a thin
shell over the headless framework: every operation delegates to the tested
backend (``project``, ``runtime.DetectRunner``, ``ui.ReviewSession``,
``silence.SilenceRunner``, ``ui.render_review_png``), so the GUI contains
no business logic of its own.  A copy of the JAX package's ``ui/qt_app.py``,
screen for screen, with the same widget names and signals; the review and
silence tables are ``Table``s (``project/table.py``), and the detector
screen detects on ``SoftspokenApp``'s ``device`` (``None``: the CUDA card).

Launch with ``python -m softspoken_tpu_torch gui`` (``--smoke`` under the
headless shim).  Import is gated: the rest of the package never depends on
Qt.
"""

from __future__ import annotations

import os
import sys
from typing import Optional


def _qt_available() -> bool:
    """Real PySide6, else this package's headless shim when asked for
    (``SOFTSPOKEN_QT_SHIM``) or when another shim already holds the name
    ``PySide6``: the app never runs against a shim not its own."""
    from .qt_shim import have_real_pyside6, install

    if have_real_pyside6():
        return True
    if os.environ.get("SOFTSPOKEN_QT_SHIM") or "PySide6" in sys.modules:
        return install()
    return False


if _qt_available():
    from PySide6.QtCore import (
        QObject, QRunnable, Qt, QThreadPool, QTimer, Signal, Slot,
    )
    from PySide6.QtGui import QAction, QColor, QKeySequence, QPixmap
    from PySide6.QtWidgets import (
        QApplication,
        QCheckBox,
        QDialog,
        QFileDialog,
        QFormLayout,
        QHBoxLayout,
        QInputDialog,
        QLabel,
        QLineEdit,
        QListWidget,
        QMainWindow,
        QMessageBox,
        QProgressBar,
        QPushButton,
        QStackedWidget,
        QTableWidget,
        QTableWidgetItem,
        QVBoxLayout,
        QWidget,
    )

    HAVE_QT = True
else:
    HAVE_QT = False

from ..config import Config, DEFAULT_CONFIG

if HAVE_QT:

    class _WorkerSignals(QObject):
        message = Signal(str)
        file_progress = Signal(float)
        overall_progress = Signal(float)
        finished = Signal(object)

    class _DetectWorker(QRunnable):
        """Background detection run (plays worker.py:21-139's role, but all
        logic lives in runtime.DetectRunner)."""

        def __init__(self, cfg: Config, project: dict, files, device=None):
            super().__init__()
            self.signals = _WorkerSignals()
            self.cfg, self.project, self.files = cfg, project, files
            self.device = device
            self._runner = None
            self._stop_requested = False

        def stop(self):
            # remember a Stop that lands before run() builds the runner
            # (Detector construction = checkpoint load + the model's move to
            # the card)
            self._stop_requested = True
            if self._runner is not None:
                self._runner.stop()

        @Slot()
        def run(self):
            from ..engine import Detector
            from ..project import DetectionStore
            from ..runtime import DetectRunner, RunCallbacks

            # Any exception must still emit finished: Qt swallows
            # QRunnable.run exceptions, which would leave the start button
            # disabled and the progress bar wedged forever
            try:
                # Detector resolves cfg.paths' model checkpoint itself (and
                # degrades to random init with a warning, like the reference)
                det = Detector(self.cfg, device=self.device)
                store = DetectionStore(self.project["detections_file"])
                self._runner = DetectRunner(det, store, self.cfg)
                if self._stop_requested:
                    self._runner.stop()
                report = self._runner.run(
                    self.files,
                    RunCallbacks(
                        message=self.signals.message.emit,
                        file_progress=self.signals.file_progress.emit,
                        overall_progress=self.signals.overall_progress.emit,
                    ),
                )
            except Exception as e:  # noqa: BLE001
                self.signals.message.emit(f"detection failed: {e}")
                report = None
            self.signals.finished.emit(report)

    class _SilenceWorker(QRunnable):
        def __init__(self, review_csv: str, output_dir: str):
            super().__init__()
            self.signals = _WorkerSignals()
            self.review_csv, self.output_dir = review_csv, output_dir
            self._runner = None
            self._stop_requested = False

        def stop(self):
            self._stop_requested = True  # see _DetectWorker.stop
            if self._runner is not None:
                self._runner.stop()

        @Slot()
        def run(self):
            from ..project.table import read_csv
            from ..silence import SilenceRunner

            try:
                self._runner = SilenceRunner(self.output_dir)
                if self._stop_requested:
                    self._runner.stop()
                report = self._runner.run(
                    read_csv(self.review_csv),  # pandas' default NA handling
                    on_file_start=lambda f: self.signals.message.emit(f"silencing {f}"),
                    on_progress=lambda p: self.signals.overall_progress.emit(float(p)),
                )
            except Exception as e:  # noqa: BLE001 — e.g. review CSV missing
                # (silence clicked before review); Qt swallows run()
                # exceptions, so report the error and still emit finished
                self.signals.message.emit(f"silencing failed: {e}")
                report = None
            self.signals.finished.emit(report)

    class HomeScreen(QWidget):
        def __init__(self, app):
            super().__init__()
            self.app = app
            lay = QVBoxLayout(self)
            lay.addWidget(QLabel("<h2>Softspoken</h2>"))
            for text, cb in [
                ("New Project", app.new_project),
                ("Open Project", app.open_project),
                ("Open Last Project", app.open_last_project),
            ]:
                b = QPushButton(text)
                b.clicked.connect(cb)
                lay.addWidget(b)
            lay.addStretch(1)

    class WorkspaceScreen(QWidget):
        """File list + 3-step workflow (mirrors AppScreen semantics)."""

        def __init__(self, app):
            super().__init__()
            self.app = app
            lay = QVBoxLayout(self)
            self.title = QLabel()
            lay.addWidget(self.title)
            self.files = QListWidget()
            lay.addWidget(self.files)
            row = QHBoxLayout()
            add = QPushButton("Add Files…")
            add.clicked.connect(self.add_files)
            rem = QPushButton("Remove Selected")
            rem.clicked.connect(self.remove_selected)
            row.addWidget(add)
            row.addWidget(rem)
            lay.addLayout(row)
            self.status = QLabel()
            lay.addWidget(self.status)
            steps = QHBoxLayout()
            for text, cb in [
                ("1 · Run Voice Detector", app.show_detector),
                ("2 · Review Detections", app.show_review),
                ("3 · Silence Voices", app.show_silence),
            ]:
                b = QPushButton(text)
                b.clicked.connect(cb)
                steps.addWidget(b)
            lay.addLayout(steps)

        def refresh(self):
            pm = self.app.pm
            self.title.setText(f"<h3>Project: {pm.current_project['name']}</h3>")
            self.files.clear()
            self.files.addItems(pm.get_unprocessed_list())
            st = pm.step_status()
            self.status.setText(
                f"Detect: {st['detect']}   Review: {st['review']}   Silence: {st['silence']}"
            )

        def add_files(self):
            paths, _ = QFileDialog.getOpenFileNames(self, "Add audio files", "", "Audio (*.wav *.flac *.aiff *.aif *.ogg)")
            if paths:
                self.app.pm.update_file_list([os.path.abspath(p) for p in paths])
                self.refresh()

        def remove_selected(self):
            selected = [i.text() for i in self.files.selectedItems()]
            if not selected:
                return
            if (
                QMessageBox.question(self, "Remove", f"Remove {len(selected)} file(s)?")
                == QMessageBox.StandardButton.Yes
            ):
                self.app.pm.remove_from_file_list(selected)
                self.refresh()

    class DetectorScreen(QWidget):
        """Progress + the audio-sec/wall-sec throughput label
        (silencer_ui.py:152-158's north-star metric)."""

        def __init__(self, app):
            super().__init__()
            self.app = app
            self.worker: Optional[_DetectWorker] = None
            lay = QVBoxLayout(self)
            lay.addWidget(QLabel("<h3>Voice Detector</h3>"))
            self.file_bar = QProgressBar()
            self.overall_bar = QProgressBar()
            lay.addWidget(QLabel("File progress"))
            lay.addWidget(self.file_bar)
            lay.addWidget(QLabel("Overall progress"))
            lay.addWidget(self.overall_bar)
            self.speed = QLabel("Processing Speed: – audio sec / real sec")
            lay.addWidget(self.speed)
            self.log = QLabel("")
            self.log.setWordWrap(True)
            lay.addWidget(self.log)
            row = QHBoxLayout()
            self.start_btn = QPushButton("Begin Processing")
            self.start_btn.clicked.connect(self.start)
            self.stop_btn = QPushButton("Stop")
            self.stop_btn.clicked.connect(self.stop)
            back = QPushButton("Back")
            back.clicked.connect(self.app.show_workspace)
            for b in (self.start_btn, self.stop_btn, back):
                row.addWidget(b)
            lay.addLayout(row)
            lay.addStretch(1)

        def start(self):
            files = self.app.pm.get_unprocessed_list()
            self.worker = _DetectWorker(self.app.cfg, self.app.pm.current_project, files,
                                        device=self.app.device)
            self.worker.signals.message.connect(self._on_message)
            self.worker.signals.file_progress.connect(lambda p: self.file_bar.setValue(int(p)))
            self.worker.signals.overall_progress.connect(
                lambda p: self.overall_bar.setValue(int(p))
            )
            self.worker.signals.finished.connect(self._on_finished)
            # disable BEFORE dispatch: guards the double-click race, and the
            # headless shim's pool runs the worker synchronously
            self.start_btn.setEnabled(False)
            QThreadPool.globalInstance().start(self.worker)

        def stop(self):
            if self.worker:
                self.worker.stop()

        def _on_message(self, msg: str):
            self.log.setText(msg)
            if "audio-sec/sec" in msg:
                self.speed.setText(f"Processing Speed: {msg.split(';')[-1].strip()}")

        def _on_finished(self, report):
            self.start_btn.setEnabled(True)
            if report is None:  # worker errored; message already emitted
                self.log.setText("detection failed — see messages")
                return
            self.log.setText(
                f"done: {report.files_done} file(s), {report.rows_added} detection(s)"
            )
            self.app.workspace.refresh()
            if not report.stopped:
                # completion pop-up (README:172 — "the user will receive a
                # pop-up notification"); suppressed for a user-initiated stop
                QMessageBox.information(
                    self, "Voice Detector",
                    f"Detection complete: {report.files_done} file(s), "
                    f"{report.rows_added} detection(s).",
                )

    class AddDetectionDialog(QDialog):
        """Add a detection by hand (review_detections.py:538-675): file name,
        start and end seconds; insertion keeps (file, start) order and the ID
        is assigned by the save-time backfill (ReviewSession.add)."""

        def __init__(self, parent=None, default_file: str = ""):
            super().__init__(parent)
            self.setWindowTitle("Add Detection")
            form = QFormLayout(self)
            self.file_edit = QLineEdit(default_file)
            self.start_edit = QLineEdit("")
            self.end_edit = QLineEdit("")
            form.addRow(QLabel("File name"), self.file_edit)
            form.addRow(QLabel("Start (s)"), self.start_edit)
            form.addRow(QLabel("End (s)"), self.end_edit)
            row = QHBoxLayout()
            ok = QPushButton("Add")
            ok.clicked.connect(self._validate_accept)
            cancel = QPushButton("Cancel")
            cancel.clicked.connect(self.reject)
            row.addWidget(ok)
            row.addWidget(cancel)
            form.addLayout(row)

        def _validate_accept(self):
            try:
                s, e = float(self.start_edit.text()), float(self.end_edit.text())
            except ValueError:
                QMessageBox.warning(self, "Add Detection", "times must be numbers")
                return
            if e <= s or not self.file_edit.text().strip():
                QMessageBox.warning(
                    self, "Add Detection", "need a file name and end > start"
                )
                return
            self.accept()

        def values(self):
            return (
                self.file_edit.text().strip(),
                float(self.start_edit.text()),
                float(self.end_edit.text()),
            )

    class ReviewScreen(QWidget):
        """Spectrogram + table + grade/zoom/play/edit over ui.ReviewSession.

        Reference parity (review_detections.py): Keep/Erase with timestamps
        and auto-advance (:677-717), power-of-2 seconds-per-inch zoom
        (:1078-1092), segment / visible-window playback (:466-536), in-table
        comment editing + add-detection dialog (:538-675), reviewed-row
        highlighting (:1002-1011), debounced re-render on resize (:40-59).
        """

        REVIEWED_COLOR = (208, 240, 192)  # pale green, same intent as :1002
        ZOOM_MIN, ZOOM_MAX = 0.125, 64.0

        def __init__(self, app):
            super().__init__()
            self.app = app
            self.session = None
            self.zoom_level = 1.0          # seconds-per-inch scale, power of 2
            self.last_play_path = None     # last exported playback WAV
            self._updating_table = False
            lay = QVBoxLayout(self)
            self.image = QLabel()
            self.image.setMinimumHeight(260)
            self.image.setAlignment(Qt.AlignmentFlag.AlignCenter)
            lay.addWidget(self.image)

            zoom_row = QHBoxLayout()
            for text, cb, key in [
                ("Zoom In (+)", self.zoom_in, "+"),
                ("Zoom Out (−)", self.zoom_out, "-"),
                ("Play Segment", self.play_segment, "Shift+Space"),
                ("Play Window", self.play_window, None),
                ("Stop", self.stop_playback, None),
            ]:
                b = QPushButton(text)
                b.clicked.connect(cb)
                if key:
                    b.setShortcut(QKeySequence(key))
                zoom_row.addWidget(b)
            self.zoom_label = QLabel("zoom: 1 s/in")
            zoom_row.addWidget(self.zoom_label)
            # editable playback range (README:194 — "edit the Start Time and
            # End Time values … for playback without editing the detection");
            # auto-filled on selection, consumed by Play Segment
            zoom_row.addWidget(QLabel("Start:"))
            self.play_start = QLineEdit()
            self.play_start.setMaximumWidth(80)
            zoom_row.addWidget(self.play_start)
            zoom_row.addWidget(QLabel("End:"))
            self.play_stop = QLineEdit()
            self.play_stop.setMaximumWidth(80)
            zoom_row.addWidget(self.play_stop)
            # 0.5 s dotted gridlines toggle (README:188 "Show Vertical Bars";
            # review_detections.py:931-944)
            self.show_bars = QCheckBox("Show Vertical Bars")
            self.show_bars.setChecked(True)
            self.show_bars.toggled.connect(lambda _v: self._render_current())
            zoom_row.addWidget(self.show_bars)
            lay.addLayout(zoom_row)

            nav_row = QHBoxLayout()
            for text, cb in [
                ("Previous", self.nav_prev),
                ("Next", self.nav_next),
                ("Previous File", self.nav_prev_file),
                ("Next File", self.nav_next_file),
            ]:
                b = QPushButton(text)
                b.clicked.connect(cb)
                nav_row.addWidget(b)
            lay.addLayout(nav_row)

            self.table = QTableWidget()
            self.table.itemSelectionChanged.connect(self._on_select)
            self.table.itemChanged.connect(self._on_item_changed)
            lay.addWidget(self.table)
            row = QHBoxLayout()
            for text, cb, key in [
                ("Keep (Shift+K)", self.keep, "Shift+K"),
                ("Erase (Shift+E)", self.erase, "Shift+E"),
                ("Add Detection…", self.add_detection, None),
                ("Delete Row", self.delete_row, None),
                ("Back", self.app.show_workspace, None),
            ]:
                b = QPushButton(text)
                b.clicked.connect(cb)
                if key:
                    b.setShortcut(QKeySequence(key))
                row.addWidget(b)
            lay.addLayout(row)

            # debounced re-render on resize (review_detections.py:40-59)
            self._resize_timer = QTimer(self)
            self._resize_timer.setSingleShot(True)
            self._resize_timer.timeout.connect(self._render_current)

        # ---- table <-> session ------------------------------------------
        def refresh(self, reload: bool = True):
            from .review import ReviewSession

            if reload or self.session is None:
                self.session = ReviewSession(
                    self.app.pm.current_project, self.app.pm.projects_folder,
                    self.app.cfg,
                )
            self._rebuild_table()

        def _rebuild_table(self):
            t = self.session.table
            reviewed = self.session.reviewed_mask()
            self._updating_table = True
            try:
                self.table.clear()
                self.table.setRowCount(len(t))
                self.table.setColumnCount(len(t.columns))
                self.table.setHorizontalHeaderLabels([str(c) for c in t.columns])
                for r in range(len(t)):
                    for c, col in enumerate(t.columns):
                        item = QTableWidgetItem(str(t.rows[r][col]))
                        if r < len(reviewed) and reviewed[r]:
                            item.setBackground(QColor(*self.REVIEWED_COLOR))
                        self.table.setItem(r, c, item)
            finally:
                self._updating_table = False
            if len(t):
                self.table.selectRow(
                    min(self.session.current_index, len(t) - 1)
                )

        def _col_index(self, name: str) -> int:
            return self.session.table.columns.index(name)

        def _on_select(self):
            r = self.table.currentRow()
            if self._updating_table or self.session is None \
                    or r < 0 or r >= len(self.session):
                return
            self.session.seek(r)
            row = self.session.rows[r]
            # refill the playback-range boxes from the selected detection
            # (the user can then edit them for ad-hoc playback)
            self.play_start.setText(f"{float(row['start_time']):.4f}")
            self.play_stop.setText(f"{float(row['end_time']):.4f}")
            self._render(r)

        def _on_item_changed(self, item):
            """In-table edits: comments and start/end times persist through
            the session (review_detections.py:106-139)."""
            if self._updating_table or self.session is None:
                return
            r, c = item.row(), item.column()
            if r < 0 or r >= len(self.session):
                return
            col = self.session.table.columns[c]
            if col == "user_comment":
                self.session.set_comment(item.text(), index=r, persist=True)
            elif col in ("start_time", "end_time"):
                try:
                    v = float(item.text())
                except ValueError:
                    return
                row = self.session.rows[r]
                s = v if col == "start_time" else float(row["start_time"])
                e = v if col == "end_time" else float(row["end_time"])
                self.session.set_times(s, e, index=r, persist=True)

        # ---- spectrogram -------------------------------------------------
        def _render_current(self):
            r = self.table.currentRow()
            if self.session is not None and 0 <= r < len(self.session):
                self._render(r)

        def _render(self, r: int):
            from .spectrogram import render_review_png

            row = self.session.rows[r]
            full = os.path.join(row["file_path"], row["file_name"])
            try:
                png = render_review_png(
                    full,
                    float(row["start_time"]),
                    float(row["end_time"]),
                    [
                        (float(q["start_time"]), float(q["end_time"]))
                        for q in self.session.rows
                        if q["file_name"] == row["file_name"]
                    ],
                    widget_width_px=max(400, self.width()),
                    zoom_level=self.zoom_level,
                    show_gridlines=self.show_bars.isChecked(),
                    config=self.app.cfg,
                )
                pix = QPixmap()
                pix.loadFromData(png)
                self.image.setPixmap(
                    pix.scaled(self.image.size(), Qt.AspectRatioMode.KeepAspectRatio)
                )
            except Exception as e:  # noqa: BLE001
                self.image.setText(f"(no spectrogram: {e})")

        def resizeEvent(self, event=None):
            self._resize_timer.start(100)

        # ---- zoom (power-of-2 seconds-per-inch, :1078-1092) --------------
        def zoom_in(self):
            self.zoom_level = max(self.ZOOM_MIN, self.zoom_level / 2.0)
            self._after_zoom()

        def zoom_out(self):
            self.zoom_level = min(self.ZOOM_MAX, self.zoom_level * 2.0)
            self._after_zoom()

        def _after_zoom(self):
            z = self.zoom_level
            self.zoom_label.setText(
                f"zoom: {z:g} s/in" if z >= 1 else f"zoom: 1/{1 / z:g} s/in"
            )
            self._render_current()

        # ---- playback (:466-536) ------------------------------------------
        def _play(self, start: float, stop: float):
            from . import playback

            row = self.session.current()
            if row is None:
                return
            full = os.path.join(row["file_path"], row["file_name"])
            try:
                if not playback.play_segment(full, (start, stop), self.app.cfg,
                                             blocking=False):
                    # no audio backend: export the temp WAV like the
                    # reference's QMediaPlayer temp-file flow (:466-525)
                    self.last_play_path = playback.export_segment_wav(
                        full, (start, stop), config=self.app.cfg
                    )
            except Exception as e:  # noqa: BLE001
                QMessageBox.warning(self, "Playback", str(e))

        def play_segment(self):
            row = self.session.current() if self.session else None
            if row is not None:
                # detection times can be negative (−3 s pad shift); clamp
                # like export_segment_wav, else load_audio_startstop rejects.
                # The playback-range boxes override the row times when they
                # parse (README:194 — play a chosen range without editing
                # the detection); cleared/invalid boxes fall back to the row.
                start = max(0.0, float(row["start_time"]))
                stop = max(start + 1e-3, float(row["end_time"]))
                try:
                    bs = float(self.play_start.text())
                    be = float(self.play_stop.text())
                    if be > bs:
                        start, stop = max(0.0, bs), be
                except (ValueError, TypeError):
                    pass
                self._play(start, stop)

        def stop_playback(self):
            from . import playback

            playback.stop_playback()

        # ---- table navigation (README:196-201; review buttons) ----------
        def _select_row(self, r: int):
            if self.session is None or not len(self.session):
                return
            r = max(0, min(r, len(self.session) - 1))
            self.table.selectRow(r)   # triggers _on_select → seek + render

        def nav_prev(self):
            self._select_row(self.table.currentRow() - 1)

        def nav_next(self):
            self._select_row(self.table.currentRow() + 1)

        def nav_prev_file(self):
            """Jump up to the LAST detection of the previous file_name."""
            if self.session is None or not len(self.session):
                return
            names = self.session.table.column("file_name")
            r = max(0, self.table.currentRow())
            cur = names[min(r, len(names) - 1)]
            for i in range(r - 1, -1, -1):
                if names[i] != cur:
                    self._select_row(i)  # last row of the previous file
                    return

        def nav_next_file(self):
            """Jump down to the FIRST detection of the next file_name."""
            if self.session is None or not len(self.session):
                return
            names = self.session.table.column("file_name")
            r = max(0, self.table.currentRow())
            cur = names[min(r, len(names) - 1)]
            for i in range(r + 1, len(names)):
                if names[i] != cur:
                    self._select_row(i)
                    return

        def play_window(self):
            from .spectrogram import plan_view_window

            row = self.session.current() if self.session else None
            if row is None:
                return
            full = os.path.join(row["file_path"], row["file_name"])
            a, b, _ = plan_view_window(
                full, float(row["start_time"]), float(row["end_time"]),
                widget_width_px=max(400, self.width()),
                zoom_level=self.zoom_level,
            )
            self._play(a, b)

        # ---- grading / rows -----------------------------------------------
        def keep(self):
            if self.session:
                self.session.keep()
                self.refresh(reload=False)

        def erase(self):
            if self.session:
                self.session.erase()
                self.refresh(reload=False)

        def add_detection(self):
            if self.session is None:
                return
            cur = self.session.current()
            dlg = AddDetectionDialog(
                self, default_file=str(cur["file_name"]) if cur is not None else ""
            )
            if dlg.exec() != QDialog.Accepted:
                return
            fname, s, e = dlg.values()
            fpath = (
                str(cur["file_path"])
                if cur is not None and str(cur["file_name"]) == fname
                else self._path_for(fname)
            )
            self.session.add(fpath, fname, s, e)
            self.refresh(reload=False)

        def _path_for(self, fname: str) -> str:
            match = [q for q in self.session.rows if q["file_name"] == fname]
            if match:
                return str(match[0]["file_path"])
            for f in self.app.pm.get_unprocessed_list():
                if os.path.basename(f) == fname:
                    return os.path.dirname(f)
            return ""

        def delete_row(self):
            r = self.table.currentRow()
            if self.session and r >= 0:
                self.session.delete([r])
                self.refresh(reload=False)

    class SilenceScreen(QWidget):
        def __init__(self, app):
            super().__init__()
            self.app = app
            self.worker = None
            lay = QVBoxLayout(self)
            lay.addWidget(QLabel("<h3>Silence Voices</h3>"))
            self.info = QLabel()
            lay.addWidget(self.info)
            self.bar = QProgressBar()
            lay.addWidget(self.bar)
            row = QHBoxLayout()
            self.start_btn = QPushButton("Choose Output Folder && Start")
            self.start_btn.clicked.connect(self.start)
            stop = QPushButton("Stop")
            stop.clicked.connect(lambda: self.worker and self.worker.stop())
            back = QPushButton("Back")
            back.clicked.connect(self.app.show_workspace)
            for b in (self.start_btn, stop, back):
                row.addWidget(b)
            lay.addLayout(row)
            lay.addStretch(1)

        def refresh(self):
            from ..project.table import read_csv, to_number

            path = self.app.pm.current_project["review_file"]
            if os.path.exists(path):
                # a zero-byte CSV (interrupted review save — step_status
                # calls that state 'In Progress') or a hand-edited one
                # without 'erase' must degrade to guidance, not crash the
                # navigation slot
                try:
                    t = read_csv(path)
                    # to_numeric(errors="coerce") == 1; no column counts 0
                    n = sum(to_number(v) == 1 for v in t.column("erase")) \
                        if "erase" in t.columns else 0
                except Exception:  # noqa: BLE001 — empty/corrupt CSV
                    self.info.setText(
                        "review file unreadable — re-run Review")
                    return
                self.info.setText(f"{n} detection(s) flagged for erasure")
            else:
                self.info.setText("no review file yet — run Review first")

        def start(self):
            outdir = QFileDialog.getExistingDirectory(self, "Output folder")
            if not outdir:
                return
            self.worker = _SilenceWorker(
                self.app.pm.current_project["review_file"], outdir
            )
            # surface worker messages (incl. the failure reason) in the
            # info label
            self.worker.signals.message.connect(self.info.setText)
            self.worker.signals.overall_progress.connect(lambda p: self.bar.setValue(int(p)))
            self.worker.signals.finished.connect(self._on_finished)
            # disable BEFORE dispatch (same double-click guard as
            # DetectorScreen: two concurrent runners would write the same
            # output WAVs)
            self.start_btn.setEnabled(False)
            QThreadPool.globalInstance().start(self.worker)

        def _on_finished(self, report):
            from ..silence import write_status_file

            self.start_btn.setEnabled(True)
            if report is None:  # worker errored; message shown in info
                return
            pm = self.app.pm
            if not report.stopped:
                write_status_file(
                    pm.current_project, pm.project_output_dir(pm.current_project["name"])
                )
                pm.save_current_project()
            self.info.setText(f"done: {len(report.outputs)} silenced file(s)")
            self.app.workspace.refresh()

    class SoftspokenApp(QMainWindow):
        """The main window; ``device`` is where the detector screen detects
        (``None``: the CUDA card)."""

        def __init__(self, cfg: Config = DEFAULT_CONFIG, device=None):
            super().__init__()
            from ..project import ProjectManager

            self.cfg = cfg
            self.device = device
            self.pm = ProjectManager(cfg)
            self.setWindowTitle("Softspoken")
            self.resize(1100, 720)

            self.stack = QStackedWidget()
            self.home = HomeScreen(self)
            self.workspace = WorkspaceScreen(self)
            self.detector = DetectorScreen(self)
            self.review = ReviewScreen(self)
            self.silence = SilenceScreen(self)
            for w in (self.home, self.workspace, self.detector, self.review, self.silence):
                self.stack.addWidget(w)
            self.setCentralWidget(self.stack)

            menu = self.menuBar().addMenu("&File")
            for text, key, cb in [
                ("New Project", "Ctrl+N", self.new_project),
                ("Open Project", "Ctrl+O", self.open_project),
                ("Close Project", "Ctrl+W", self.close_project),
                ("Quit", "Ctrl+Q", self.close),
            ]:
                act = QAction(text, self)
                act.setShortcut(QKeySequence(key))
                act.triggered.connect(cb)
                menu.addAction(act)
            helpm = self.menuBar().addMenu("&Help")
            guide = QAction("User Guide", self)
            guide.setShortcut(QKeySequence("Ctrl+U"))
            guide.triggered.connect(self.open_guide)
            helpm.addAction(guide)

        # ---- navigation ------------------------------------------------
        def close_project(self):
            """Back to the start-up screen (README:151 — File > Close
            Project / Ctrl+W); any in-review edits were already persisted
            per grade/edit (the session saves on every change)."""
            self.stack.setCurrentWidget(self.home)

        def show_workspace(self):
            self.workspace.refresh()
            self.stack.setCurrentWidget(self.workspace)

        def show_detector(self):
            self.stack.setCurrentWidget(self.detector)

        def show_review(self):
            self.review.refresh()
            self.stack.setCurrentWidget(self.review)

        def show_silence(self):
            self.silence.refresh()
            self.stack.setCurrentWidget(self.silence)

        # ---- project flows ----------------------------------------------
        def new_project(self):
            name, ok = QInputDialog.getText(self, "New Project", "Project name:")
            if ok and name:
                try:
                    self.pm.add_project(name)
                except ValueError as e:
                    QMessageBox.warning(self, "New Project", str(e))
                    return
                self.pm.set_active_project(name)
                self.show_workspace()

        def open_project(self):
            names = self.pm.list_projects_by_name()
            if not names:
                QMessageBox.information(self, "Open Project", "No projects yet.")
                return
            name, ok = QInputDialog.getItem(self, "Open Project", "Project:", names, 0, False)
            if ok and name:
                self.pm.set_active_project(name)
                self.show_workspace()

        def open_last_project(self):
            if self.pm.activate_latest():
                self.show_workspace()
            else:
                QMessageBox.information(self, "Open Last", "No projects yet.")

        def open_guide(self):
            import webbrowser

            webbrowser.open(self.cfg.paths.user_guide_url)


def _make_smoke_demo_project(win, cfg: Config) -> None:
    """Self-contained demo content for ``gui --smoke --screenshot`` when no
    project exists yet: one synthesized recording with a speech-band burst
    plus its detection row, so the review screen has a spectrogram to
    render."""
    import numpy as np

    from ..io import wavio
    from ..project.store import DetectionStore

    win.pm.add_project("smoke-demo")
    proj = win.pm.set_active_project("smoke-demo")
    out_dir = win.pm.project_output_dir("smoke-demo")
    sr = 22050
    t = np.arange(4 * sr) / sr
    rng = np.random.default_rng(0)
    audio = (0.02 * rng.standard_normal(len(t))).astype(np.float32)
    m = (t > 1.0) & (t < 2.2)
    audio[m] += 0.4 * np.sin(2 * np.pi * 700 * t[m]).astype(np.float32)
    wav = os.path.join(out_dir, "smoke_demo.wav")
    wavio.write(wav, audio, sr, subtype="PCM_16")
    win.pm.update_file_list([wav])
    store = DetectionStore.for_project(proj)
    store.append_intervals(wav, [(1.0, 2.2)])
    store.save()


def smoke(cfg: Config = DEFAULT_CONFIG, screenshot: Optional[str] = None,
          device=None) -> int:
    """Construct every screen, click through the navigation, and optionally
    save the review spectrogram to ``screenshot``. Works headless (under the
    qt_shim) and under real PySide6 with QT_QPA_PLATFORM=offscreen."""
    if not HAVE_QT:
        sys.exit("no Qt available — set SOFTSPOKEN_QT_SHIM=1 for the headless shim")
    app = QApplication.instance() or QApplication(sys.argv)  # noqa: F841
    win = SoftspokenApp(cfg, device=device)
    win.show()
    if win.stack.currentWidget() is not win.home:
        sys.exit("smoke: the app did not open on its home screen")
    if not win.pm.activate_latest() and screenshot:
        _make_smoke_demo_project(win, cfg)
    if win.pm.activate_latest():
        win.show_workspace()
        for nav in (win.show_detector, win.show_review, win.show_silence):
            nav()
        if screenshot:
            # real Qt6 QLabel.pixmap() returns a NULL pixmap (never None)
            # when rendering failed, and .save() returns False — both must
            # fail the smoke gate, not print success
            pm = win.review.image.pixmap()
            ok = (pm is not None
                  and not (hasattr(pm, "isNull") and pm.isNull())
                  and bool(pm.save(screenshot)))
            if not ok:
                win.close()
                sys.exit("smoke: review spectrogram failed to render/save")
            print(f"screenshot → {screenshot}")
    win.close()
    print("gui smoke ok: 5 screens constructed, navigation wired")
    return 0


def main(cfg: Config = DEFAULT_CONFIG, smoke_mode: bool = False,
         screenshot: Optional[str] = None, device=None) -> int:
    if smoke_mode:
        return smoke(cfg, screenshot, device=device)
    if not HAVE_QT:
        sys.exit("PySide6 is not installed; use the headless CLI: "
                 "python -m softspoken_tpu_torch")
    app = QApplication(sys.argv)
    win = SoftspokenApp(cfg, device=device)
    win.show()
    return app.exec()


if __name__ == "__main__":
    raise SystemExit(main())
