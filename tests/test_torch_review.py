"""The port's headless review against the JAX package's ``ui/``: one
scripted session on both gives a byte-identical review.csv and export
files, equal stats and equal rows after a reload; the load-time filter,
the sort and the erase coercion follow pandas; the spectrogram helpers
agree within 1e-6."""

import os
from pathlib import Path

import numpy as np
import pytest

from softspoken_tpu import Config as JConfig
from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu.project import ProjectManager as JManager
from softspoken_tpu.ui import ReviewSession as JSession
from softspoken_tpu.ui import playback as jplayback
from softspoken_tpu.ui import spectrogram as jspec
from softspoken_tpu_torch import Config
from softspoken_tpu_torch.project import ProjectManager
from softspoken_tpu_torch.ui import ReviewSession
from softspoken_tpu_torch.ui import playback, spectrogram


def _now():
    return "2026-08-16 12:00:00"


DETECTIONS = (
    "ID,file_path,file_name,start_time,end_time,erase,user_comment,review_datetime\n"
    "1,{w},b.wav,1.0,1.5,0,,\n"
    "2,{w},a.wav,2.0,2.05,0,,\n"          # 0.05 s: filtered out on load
    "3,{w},a.wav,0.5,1.2,0,,\n"
    ",{w},a.wav,3.25,4.0,0,\"hand, added\",\n"  # no ID: backfilled
    "5,{w},a.wav,oops,4.0,0,,\n"          # non-numeric start: filtered out
    "6,{w},c.wav,-3.0,6.5859000000000005,0,,\n"
    "7,{w},a.wav,0.5,0.9,0,,\n"           # ties a.wav@0.5: stable order
)


@pytest.fixture
def audio_dir(tmp_path):
    wavdir = tmp_path / "audio"
    wavdir.mkdir()
    rng = np.random.default_rng(0)
    for name in ["a.wav", "b.wav", "c.wav"]:
        jwavio.write(str(wavdir / name),
                     rng.uniform(-0.5, 0.5, 22050 * 8).astype(np.float32), 22050)
    return str(wavdir)


def _projects(tmp_path, wavdir, text=DETECTIONS, review=False):
    """The same project in both packages' project dirs."""
    port = ProjectManager(Config().with_paths(project_dir=str(tmp_path / "port")))
    jax = JManager(JConfig().with_paths(project_dir=str(tmp_path / "jax")))
    out = []
    for pm in (port, jax):
        pm.add_project("rev")
        proj = pm.set_active_project("rev")
        with open(proj["review_file" if review else "detections_file"], "w") as f:
            f.write(text.format(w=wavdir))
        out.append((pm, proj))
    return out


def _sessions(tmp_path, wavdir, **kw):
    (pm, proj), (jpm, jproj) = _projects(tmp_path, wavdir, **kw)
    return (ReviewSession(proj, pm.projects_folder, Config(), now_fn=_now),
            JSession(jproj, jpm.projects_folder, JConfig(), now_fn=_now))


def _rows(session):
    if isinstance(session, ReviewSession):
        return [dict(r) for r in session.rows]
    return session.df.to_dict("records")


def _same_rows(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert list(ra) == list(rb)
        for k in ra:
            va, vb = ra[k], rb[k]
            if isinstance(vb, float) and np.isnan(vb):
                assert isinstance(va, float) and np.isnan(va), k
            else:
                assert va == vb and type(va) is type(vb), (k, va, vb)


def _tree(root):
    root = Path(root)
    skip = {"projects.json"}
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and p.name not in skip}


def _script(s, wavdir):
    s.keep()
    s.erase()
    s.set_comment("needs a second listen, \"maybe\"", index=0)
    s.set_times(0.4, 1.3, index=0)
    s.add(wavdir, "a.wav", 0.9, 1.8)
    s.add("/elsewhere", "zz.wav", 1.0, 2.0, persist=False)
    assert s.add("/x", "a.wav", 2.0, 1.0) is None
    s.erase(index=2, persist=False)
    s.delete([-1])
    s.keep(index=99)  # out of range: no-op
    s.seek(99)
    s.prev()
    return s.stats(), s.current_index


def test_load_filters_sorts_and_backfills_like_jax(tmp_path, audio_dir):
    s, js = _sessions(tmp_path, audio_dir)
    assert len(s) == len(js) == 5
    _same_rows(_rows(s), _rows(js))
    assert s.stats() == js.stats()
    assert s.reviewed_mask().tolist() == js.reviewed_mask().tolist()


def test_scripted_session_byte_identical(tmp_path, audio_dir):
    s, js = _sessions(tmp_path, audio_dir)
    assert _script(s, audio_dir) == _script(js, audio_dir)
    s.save()
    js.save()
    port, jax = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert "Softspoken Outputs/rev/rev_review.csv" in port
    assert "Kaleidoscope Outputs/rev/rev.csv" in port
    assert port == jax
    _same_rows(_rows(s), _rows(js))
    # reload from the review CSV
    s2 = ReviewSession(s.project, s.projects_folder, Config())
    js2 = JSession(js.project, js.projects_folder, JConfig())
    _same_rows(_rows(s2), _rows(js2))
    assert s2.stats() == js2.stats()


ERASE_VALUES = ["1", "1.0", "", "yes", "0", " 1", "2", "1.5"]


def test_review_csv_erase_coercion_like_jax(tmp_path, audio_dir):
    """A hand-edited review CSV: stats count erase by pd.to_numeric == 1,
    and save writes to_numeric(coerce).fillna(0).astype(int)."""
    lines = ["ID,file_path,file_name,start_time,end_time,erase,user_comment,review_datetime"]
    for i, e in enumerate(ERASE_VALUES):
        lines.append(f"{i + 1},{audio_dir},a.wav,{i}.5,{i + 1},\"{e}\",,{'x' if i % 2 else ''}")
    s, js = _sessions(tmp_path, audio_dir, text="\n".join(lines) + "\n", review=True)
    _same_rows(_rows(s), _rows(js))
    assert s.stats() == js.stats()
    s.save()
    js.save()
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_empty_session_edits_are_noops_like_jax(tmp_path, audio_dir):
    s, js = _sessions(tmp_path, audio_dir)
    for sess in (s, js):
        sess.delete(list(range(len(sess))), persist=False)
        sess.set_comment("note")
        sess.set_times(1.0, 2.0)
        sess.keep()
        sess.save()
    assert len(s) == len(js) == 0 and s.stats() == js.stats()
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_no_detections_file_gives_an_empty_session(tmp_path):
    port = ProjectManager(Config().with_paths(project_dir=str(tmp_path / "p")))
    port.add_project("e")
    s = ReviewSession(port.set_active_project("e"), port.projects_folder, Config())
    assert len(s) == 0 and s.current() is None
    assert s.stats() == {"total": 0, "reviewed": 0, "erased": 0, "kept": 0}


@pytest.mark.parametrize("seconds,trim", [(3.0, True), (3.0, False), (0.7, False)])
def test_display_spec_and_db_match_jax(seconds, trim):
    x = np.random.default_rng(1).normal(0, 0.2, int(22050 * seconds)).astype(np.float32)
    a, b = spectrogram.display_spec(x, trim), jspec.display_spec(x, trim)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    np.testing.assert_allclose(spectrogram.amplitude_to_db(a.astype(np.float64) ** 2),
                               jspec.amplitude_to_db(b.astype(np.float64) ** 2),
                               atol=1e-6, rtol=0)
    for ref, top in ((1.0, None), (None, 40.0)):
        np.testing.assert_allclose(spectrogram.amplitude_to_db(a, ref=ref, top_db=top),
                                   jspec.amplitude_to_db(b, ref=ref, top_db=top),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("det", [(4.0, 4.5), (7.5, 7.9), (0.0, 0.3), (-1.0, 9.0)])
def test_plan_view_window_matches_jax(audio_dir, det):
    p = os.path.join(audio_dir, "a.wav")
    for kw in ({}, {"widget_width_px": 96 * 6, "dpi": 96, "zoom_level": 2.0}):
        assert spectrogram.plan_view_window(p, *det, **kw) == jspec.plan_view_window(p, *det, **kw)


def test_export_segment_wav_bytes_equal(tmp_path, audio_dir):
    p = os.path.join(audio_dir, "b.wav")
    for seg in ((1.0, 2.5), (-3.0, 0.5)):
        a, b = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
        assert playback.export_segment_wav(p, seg, a) == a
        jplayback.export_segment_wav(p, seg, b)
        assert open(a, "rb").read() == open(b, "rb").read()
    with pytest.raises(IOError):
        playback.export_segment_wav(p, (5.0, 4.0), str(tmp_path / "x.wav"))


def test_playback_without_a_backend_returns_false(audio_dir):
    try:
        import sounddevice  # noqa: F401
        pytest.skip("sounddevice is installed: playback would start")
    except Exception:  # noqa: BLE001 — absent or without a device
        pass
    p = os.path.join(audio_dir, "a.wav")
    assert playback.play_segment(p, (0.0, 0.5)) is False
    assert playback.stop_playback() is False
    assert jplayback.play_segment(p, (0.0, 0.5)) is False


def test_render_review_png_matches_jax(audio_dir):
    pytest.importorskip("matplotlib")
    p = os.path.join(audio_dir, "a.wav")
    kw = dict(other_detections=[(0.5, 1.2), (2.0, 2.8)], widget_width_px=480,
              widget_height_px=320)
    png = spectrogram.render_review_png(p, 2.0, 2.8, config=Config(), **kw)
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and len(png) > 5000
    assert png == jspec.render_review_png(p, 2.0, 2.8, config=JConfig(), **kw)


def _decode_rgb_png(png):
    """An 8-bit RGB PNG with filter 0 rows (what ``_plain_png`` writes) as
    an (h, w, 3) uint8 array."""
    import struct
    import zlib

    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        kind, body = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", png[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, color, _c, _f, interlace = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    assert (depth, color, interlace) == (8, 2, 0) and b"IEND" in chunks
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    assert not raw[:, 0].any()  # filter type 0 on every row
    return raw[:, 1:].reshape(h, w, 3)


def test_render_review_png_without_matplotlib(audio_dir, monkeypatch):
    """Where matplotlib is absent (the card's machine) the review image is
    the spectrogram itself: grayscale from the display dB's min to its max,
    origin lower, the detection 30% red, another detection 30% blue."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises
    p = os.path.join(audio_dir, "a.wav")
    png = spectrogram.render_review_png(p, 2.0, 2.8, [(0.5, 1.2), (2.0, 2.8)],
                                        widget_width_px=480, widget_height_px=320,
                                        show_gridlines=False, config=Config())
    img = _decode_rgb_png(png).astype(np.int64)
    assert img.shape == (160, 480, 3)
    a0, a1, total = spectrogram.plan_view_window(p, 2.0, 2.8, 480)
    t = (np.arange(480) + 0.5) / 480 * total + a0
    plain = (t < 0.5) | ((t > 1.2) & (t < 2.0)) | (t > 2.8)
    red, blue = (t >= 2.0) & (t <= 2.8), (t >= 0.5) & (t <= 1.2)
    assert plain.any() and red.any() and blue.any()
    gray = img[:, plain]
    assert (gray[..., 0] == gray[..., 1]).all() and (gray[..., 1] == gray[..., 2]).all()
    assert gray.min() == 0 or gray.max() == 255
    assert (img[:, red, 0] >= img[:, red, 2]).all() and (img[:, red, 0] > img[:, red, 2]).any()
    assert (img[:, blue, 2] >= img[:, blue, 0]).all() and (img[:, blue, 2] > img[:, blue, 0]).any()
    # the top row is the highest frequency bin, the bottom row the lowest
    data, _sr = spectrogram.load_audio_startstop(p, (a0, a1), target_sr=22050)
    flipped = np.abs(spectrogram.amplitude_to_db(
        spectrogram.display_spec(data, trim_edges=False).astype(np.float64) ** 2))
    want = (flipped - flipped.min()) / (flipped.max() - flipped.min()) * 255
    col = int(np.flatnonzero(plain)[0])
    src = min(int((col + 0.5) * flipped.shape[1] / 480), flipped.shape[1] - 1)
    assert img[-1, col, 0] == int(np.rint(want[0, src]))
    assert img[0, col, 0] == int(np.rint(want[-1, src]))
    with_grid = spectrogram.render_review_png(p, 2.0, 2.8, widget_width_px=480,
                                              widget_height_px=320, config=Config())
    assert with_grid != png and _decode_rgb_png(with_grid).shape == (160, 480, 3)
