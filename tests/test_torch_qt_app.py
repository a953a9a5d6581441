"""The port's Qt shell (softspoken_tpu_torch/ui/qt_app.py) under its own
headless shim, on the CPU: the flows of tests/test_qt_app.py, screen for
screen, with ``device="cpu"``; the detector screen's detections CSV against
the JAX app's on the same fixture and config; and the port's shim keeping
the name ``PySide6`` to itself after the JAX package's shim installed it in
the same process.

Both configs point the checkpoint at a directory without one, so both apps
detect with the seeded fixture weights (the JAX test gets the same from its
working directory, which holds no checkpoint)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from softspoken_tpu import Config as JConfig
from softspoken_tpu_torch import Config
from softspoken_tpu_torch.io import wavio
from softspoken_tpu_torch.project.table import Table, read_csv, write_csv
from softspoken_tpu_torch.ui.qt_shim import SHIM_DIR, install

install()

from softspoken_tpu_torch.ui import qt_app  # noqa: E402  (needs the port's shim)
from PySide6.QtWidgets import (  # noqa: E402
    QApplication, QFileDialog, QInputDialog, QMessageBox,
)

assert qt_app.HAVE_QT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _recording(path):
    """One 2 s recording with a loud band-limited burst (tests/test_qt_app.py)."""
    sr = 22050
    t = np.arange(2 * sr) / sr
    audio = (0.01 * np.random.default_rng(0).standard_normal(len(t))).astype(np.float32)
    audio[(t > 0.5) & (t < 1.0)] += 0.5 * np.sin(2 * np.pi * 700 * t[(t > 0.5) & (t < 1.0)]).astype(np.float32)
    wavio.write(path, audio, sr, subtype="PCM_16")


def _jax_qt_app():
    """The JAX app, under the JAX package's shim.  tests/test_qt_app.py
    installs that shim and imports the app when it is collected; without it
    this installs the shim, imports the app and gives the name ``PySide6``
    back to the port's shim (each app keeps the classes it bound)."""
    if "softspoken_tpu.ui.qt_app" not in sys.modules:
        from softspoken_tpu.ui.qt_shim import install as jax_install

        jax_install()
        import softspoken_tpu.ui.qt_app  # noqa: F401
        install()
    from softspoken_tpu.ui import qt_app as jqt_app

    assert jqt_app.HAVE_QT
    return jqt_app


def _cfg(cls, tmp_path, name="projects", **engine):
    return (cls().with_paths(project_dir=str(tmp_path / name),
                             model_dir=str(tmp_path / "no_checkpoint"))
            .with_engine(precision="parity", device_batch=4, chunk_seconds=12.0, **engine))


@pytest.fixture
def app_env(tmp_path, monkeypatch):
    """A SoftspokenApp on the CPU over an isolated project dir with one WAV."""
    monkeypatch.chdir(tmp_path)
    wav = str(tmp_path / "rec.wav")
    _recording(wav)
    QApplication.instance() or QApplication([])
    win = qt_app.SoftspokenApp(_cfg(Config, tmp_path), device="cpu")
    win.show()
    return win, wav, tmp_path


def _make_project(win, wav, monkeypatch, name="proj", app_module=qt_app):
    """New project ``name`` holding ``wav``, through the dialogs of the shim
    that ``app_module`` (the port's or the JAX app) runs against."""
    monkeypatch.setattr(app_module.QInputDialog, "getText",
                        staticmethod(lambda *a, **k: (name, True)))
    win.home._layout.items  # touch: home screen built
    win.new_project()
    assert win.pm.current_project["name"] == name
    monkeypatch.setattr(app_module.QFileDialog, "getOpenFileNames",
                        staticmethod(lambda *a, **k: ([wav], "")))
    win.workspace.add_files()
    return win.pm.current_project


def test_all_screens_construct_and_navigate(app_env):
    win, _, _ = app_env
    assert win.stack.currentWidget() is win.home
    assert win.device == "cpu"
    menus = win.menuBar().shim_menus()
    assert [m._title for m in menus] == ["&File", "&Help"]
    assert len(menus[0].actions()) == 4  # New/Open/Close Project + Quit


def test_project_flow_and_file_list(app_env, monkeypatch):
    win, wav, _ = app_env
    _make_project(win, wav, monkeypatch)
    assert win.stack.currentWidget() is win.workspace
    assert win.workspace.files.count() == 1
    assert "Not Started" in win.workspace.status.text() or "not" in win.workspace.status.text().lower()

    # remove with confirm dialog (default answer Yes)
    win.workspace.files.shim_selectRows([0])
    win.workspace.remove_selected()
    assert win.workspace.files.count() == 0
    # declined confirm leaves the list alone
    monkeypatch.setattr(QFileDialog, "getOpenFileNames",
                        staticmethod(lambda *a, **k: ([wav], "")))
    win.workspace.add_files()
    monkeypatch.setattr(QMessageBox, "_question_answer",
                        QMessageBox.StandardButton.No)
    win.workspace.files.shim_selectRows([0])
    win.workspace.remove_selected()
    assert win.workspace.files.count() == 1


def test_detector_screen_runs_detection(app_env, monkeypatch):
    win, wav, _ = app_env
    _make_project(win, wav, monkeypatch)
    win.show_detector()
    assert win.stack.currentWidget() is win.detector
    win.detector.start_btn.click()     # synchronous under the shim
    assert win.detector.start_btn.isEnabled()  # re-enabled on finish
    assert win.detector.overall_bar.value() == 100
    assert "done" in win.detector.log.text()
    assert os.path.exists(win.pm.current_project["detections_file"])
    assert len(read_csv(win.pm.current_project["detections_file"])) >= 1


def _detect_then_review(win, wav, monkeypatch):
    _make_project(win, wav, monkeypatch)
    win.show_detector()
    win.detector.start_btn.click()
    win.show_review()
    return win.review


@pytest.mark.slow
def test_review_grade_highlight_and_zoom(app_env, monkeypatch):
    win, wav, _ = app_env
    review = _detect_then_review(win, wav, monkeypatch)
    assert win.stack.currentWidget() is win.review
    assert review.table.rowCount() >= 1
    # spectrogram rendered into the pixmap label
    assert review.image.pixmap() is not None
    assert review.image.pixmap().data[:8] == b"\x89PNG\r\n\x1a\n"

    # grade: keep row 0 → timestamp + pale-green highlight after refresh
    review.table.selectRow(0)
    review.keep()
    assert review.session.rows[0]["erase"] == 0
    assert str(review.session.rows[0]["review_datetime"]) != ""
    bg = review.table.item(0, 0).background().color()
    assert (bg.r, bg.g, bg.b) == review.REVIEWED_COLOR

    # zoom halves/doubles seconds-per-inch, clamped, re-renders
    z0 = review.zoom_level
    review.zoom_in()
    assert review.zoom_level == z0 / 2
    review.zoom_out()
    review.zoom_out()
    assert review.zoom_level == z0 * 2
    assert "s/in" in review.zoom_label.text()
    for _ in range(20):
        review.zoom_out()
    assert review.zoom_level == review.ZOOM_MAX


def test_review_playback_exports_segment(app_env, monkeypatch):
    win, wav, _ = app_env
    review = _detect_then_review(win, wav, monkeypatch)
    review.table.selectRow(0)
    review.play_segment()   # no sounddevice here → temp-WAV export path
    assert review.last_play_path and os.path.exists(review.last_play_path)
    seg_info = wavio.info(review.last_play_path)
    assert seg_info.samplerate == 22050
    first = review.last_play_path

    review.play_window()    # visible-window playback (plan_view_window range)
    assert review.last_play_path != first
    win_info = wavio.info(review.last_play_path)
    assert win_info.frames >= seg_info.frames  # window ⊇ detection


def test_review_comment_editing_persists(app_env, monkeypatch):
    win, wav, _ = app_env
    review = _detect_then_review(win, wav, monkeypatch)
    c = review._col_index("user_comment")
    review.table.item(0, c).setText("wind turbine, not speech")
    # persisted through the session to the review CSV
    t = read_csv(win.pm.current_project["review_file"])
    assert t.rows[0]["user_comment"] == "wind turbine, not speech"


def test_review_add_and_delete_rows(app_env, monkeypatch):
    win, wav, _ = app_env
    review = _detect_then_review(win, wav, monkeypatch)
    n0 = len(review.session)

    DialogCls = qt_app.AddDetectionDialog
    dlg = DialogCls(review, default_file="rec.wav")
    dlg.start_edit.setText("0.100")
    dlg.end_edit.setText("0.250")
    dlg._validate_accept()
    assert dlg.result() == dlg.Accepted
    monkeypatch.setattr(qt_app, "AddDetectionDialog", lambda *a, **k: dlg)
    review.add_detection()
    rows = review.session.rows
    assert len(rows) == n0 + 1
    assert any(r["start_time"] == 0.1 and r["end_time"] == 0.25 for r in rows)
    # insertion preserved (file_name, start_time) order
    key = [(r["file_name"], float(r["start_time"])) for r in rows]
    assert key == sorted(key)

    review.table.selectRow(0)
    review.delete_row()
    assert len(review.session) == n0

    # dialog validation: end ≤ start is rejected with a warning
    bad = DialogCls(review, default_file="rec.wav")
    bad.start_edit.setText("2.0")
    bad.end_edit.setText("1.0")
    bad._validate_accept()
    assert bad.result() == bad.Rejected
    assert QMessageBox._log[-1][0] == "warning"


def test_review_resize_debounce_rerenders(app_env, monkeypatch):
    win, wav, _ = app_env
    review = _detect_then_review(win, wav, monkeypatch)
    review.image.setText("stale")           # clear pixmap
    assert review.image.pixmap() is None
    review.resizeEvent(None)                 # debounce timer fires (shim: now)
    assert review.image.pixmap() is not None


def test_silence_screen_end_to_end(app_env, monkeypatch, tmp_path):
    win, wav, _ = app_env
    review = _detect_then_review(win, wav, monkeypatch)
    review.table.selectRow(0)
    review.erase()                           # flag row 0 for erasure

    win.show_silence()
    assert "1 detection(s) flagged for erasure" in win.silence.info.text()
    outdir = str(tmp_path / "silenced")
    monkeypatch.setattr(QFileDialog, "getExistingDirectory",
                        staticmethod(lambda *a, **k: outdir))
    win.silence.start()
    assert "done: 1 silenced" in win.silence.info.text()
    out = os.path.join(outdir, "rec_silenced.wav")
    assert os.path.exists(out)
    # the erased interval is actually zeroed
    t = read_csv(win.pm.current_project["review_file"])
    row = [r for r in t.rows if r["erase"] == 1][0]
    data, sr = wavio.read(out)
    s, e = int(round(row["start_time"] * sr)), int(round(row["end_time"] * sr))
    s = max(0, s)
    assert np.abs(data[s:e]).max() == 0.0


def test_gui_smoke_mode(app_env, monkeypatch, tmp_path):
    win, wav, _ = app_env
    _make_project(win, wav, monkeypatch)
    shot = str(tmp_path / "review.png")
    # run detection so the review screen has something to render
    win.show_detector()
    win.detector.start_btn.click()
    rc = qt_app.smoke(win.cfg, screenshot=shot, device="cpu")
    assert rc == 0
    assert os.path.exists(shot) and open(shot, "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def test_play_segment_clamps_negative_start(app_env, monkeypatch):
    """Pad-shifted detections can have negative start times; play must clamp
    like export_segment_wav instead of silently doing nothing."""
    win, wav, _ = app_env
    _make_project(win, wav, monkeypatch)
    proj = win.pm.current_project
    write_csv(proj["detections_file"], Table.from_columns({
        "ID": [1], "file_path": [os.path.dirname(wav)],
        "file_name": [os.path.basename(wav)], "start_time": [-1.2],
        "end_time": [0.8], "erase": [0], "user_comment": [""],
        "review_datetime": [""]}))
    win.show_review()
    seen = {}

    def fake_play(self, start, stop):
        seen["range"] = (start, stop)

    monkeypatch.setattr(type(win.review), "_play", fake_play)
    win.review.play_segment()
    assert seen["range"][0] == 0.0
    assert seen["range"][1] == pytest.approx(0.8)


def test_silence_screen_double_click_guard_and_messages(app_env, monkeypatch,
                                                        tmp_path):
    """start disables its button before dispatch and the worker's messages
    reach the info label."""
    win, wav, _ = app_env
    _make_project(win, wav, monkeypatch)
    win.show_silence()
    outdir = str(tmp_path / "sil2")
    monkeypatch.setattr(QFileDialog, "getExistingDirectory",
                        staticmethod(lambda *a, **k: outdir))
    # no review CSV yet: the worker fails and the REASON must be displayed
    assert not os.path.exists(win.pm.current_project["review_file"])
    win.silence.start()
    assert "silencing failed" in win.silence.info.text()
    assert win.silence.start_btn.isEnabled()  # re-enabled after finish


def test_detect_worker_stop_before_runner_is_honored(app_env, monkeypatch):
    """A Stop click that lands while the Detector is still constructing
    must not be lost."""
    win, wav, _ = app_env
    _make_project(win, wav, monkeypatch)
    w = qt_app._DetectWorker(win.cfg, win.pm.current_project, [wav], device="cpu")
    results = []
    w.signals.finished.connect(results.append)
    w.stop()      # BEFORE run() builds the runner
    w.run()
    (report,) = results
    assert report is not None and report.stopped


def test_review_navigation_and_bars_toggle(app_env, monkeypatch):
    """Previous/Next (+ per-file jumps), the Show Vertical Bars toggle,
    playback-range boxes, Stop, Close Project."""
    win, wav, _ = app_env
    review = _detect_then_review(win, wav, monkeypatch)
    n = review.table.rowCount()
    assert n >= 1

    # selection fills the playback boxes with the row times
    review.table.selectRow(0)
    row0 = review.session.rows[0]
    assert float(review.play_start.text()) == pytest.approx(
        float(row0["start_time"]), abs=1e-4)
    assert float(review.play_stop.text()) == pytest.approx(
        float(row0["end_time"]), abs=1e-4)

    # edited boxes override the row times for playback (temp-WAV path here)
    review.play_start.setText("0.0")
    review.play_stop.setText("0.25")
    review.play_segment()
    assert review.last_play_path and os.path.exists(review.last_play_path)
    seg = wavio.info(review.last_play_path)
    assert abs(seg.frames / seg.samplerate - 0.25) < 0.02
    review.stop_playback()  # no backend here → harmless no-op

    # nav: next/prev clamp at the ends
    review.nav_next()
    assert review.table.currentRow() == min(1, n - 1)
    review.nav_prev()
    review.nav_prev()
    assert review.table.currentRow() == 0
    # single-file project: file jumps are no-ops, not crashes
    review.nav_next_file()
    review.nav_prev_file()

    # vertical-bars checkbox re-renders (PNG stays valid either way)
    review.show_bars.setChecked(False)
    assert review.image.pixmap().data[:8] == b"\x89PNG\r\n\x1a\n"
    review.show_bars.setChecked(True)

    # Close Project returns to the start-up screen (Ctrl+W contract)
    win.close_project()
    assert win.stack.currentWidget() is win.home


def test_review_file_jumps_two_files(app_env, monkeypatch):
    """Previous File / Next File move to the adjacent file's detections."""
    win, wav, _ = app_env
    review = _detect_then_review(win, wav, monkeypatch)
    # a second file's row, straight into the session's table
    rows = review.session.rows
    extra = dict(rows[0], file_name="zzz_other.wav", ID=max(r["ID"] for r in rows) + 1)
    rows.append(extra)
    review._rebuild_table()

    review.table.selectRow(0)
    review.nav_next_file()
    r = review.table.currentRow()
    assert review.session.rows[r]["file_name"] == "zzz_other.wav"
    review.nav_prev_file()
    r2 = review.table.currentRow()
    assert review.session.rows[r2]["file_name"] != "zzz_other.wav"


def test_detector_screen_csv_equals_the_jax_apps(tmp_path, monkeypatch):
    """The same 2 s fixture through both apps' detector screens (parity
    mode, host pipeline, fixture weights): the same detections CSV, byte for
    byte, so the same rows and intervals."""
    monkeypatch.chdir(tmp_path)
    wav = str(tmp_path / "rec.wav")
    _recording(wav)
    csvs = {}
    for name, mod, cls, kw in (("port", qt_app, Config, {"device": "cpu"}),
                               ("jax", _jax_qt_app(), JConfig, {})):
        mod.QApplication.instance() or mod.QApplication([])
        win = mod.SoftspokenApp(_cfg(cls, tmp_path, name, pipeline="host"), **kw)
        win.show()
        _make_project(win, wav, monkeypatch, app_module=mod)
        win.show_detector()
        win.detector.start_btn.click()
        assert "done: 1 file(s)" in win.detector.log.text(), win.detector.log.text()
        with open(win.pm.current_project["detections_file"], "rb") as f:
            csvs[name] = f.read()
    assert csvs["port"].count(b"\n") >= 2  # a header and at least one row
    assert csvs["port"] == csvs["jax"]


def test_the_ports_shim_keeps_pyside6_to_itself():
    """Both shims in this process: every class the port's app uses comes
    from the port's files, the JAX app keeps its own, and ``install``
    resolves ``PySide6`` to the port's files whichever shim holds it.  In a
    fresh interpreter, the port's app imported after the JAX shim took
    ``PySide6`` (no SOFTSPOKEN_QT_SHIM) installs its own shim too."""
    jqt_app = _jax_qt_app()
    assert install()
    import PySide6

    def source(cls):
        return next(f.__code__.co_filename for f in vars(cls).values()
                    if hasattr(f, "__code__"))

    assert os.path.dirname(os.path.dirname(PySide6.__file__)) == SHIM_DIR
    for name in ("QApplication", "QThreadPool", "QPixmap", "QTableWidget"):
        assert source(getattr(qt_app, name)).startswith(SHIM_DIR + os.sep), name
        assert not source(getattr(jqt_app, name)).startswith(SHIM_DIR + os.sep), name
    code = (
        "import os, sys\n"
        "from softspoken_tpu.ui.qt_shim import install\n"
        "install()\n"
        "import PySide6\n"
        "jax_file = PySide6.__file__\n"
        "from softspoken_tpu_torch.ui import qt_app\n"
        "from softspoken_tpu_torch.ui.qt_shim import SHIM_DIR, install as port_install\n"
        "import PySide6\n"
        "assert qt_app.HAVE_QT\n"
        "assert PySide6.__file__ != jax_file, jax_file\n"
        "assert PySide6.__file__.startswith(SHIM_DIR + os.sep), PySide6.__file__\n"
        "assert sys.modules[qt_app.QWidget.__module__].__file__.startswith(SHIM_DIR)\n"
        "assert port_install()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("SOFTSPOKEN_QT_SHIM", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
