"""The port's exporters against the JAX package's on the fixtures of
tests/test_export.py (and a few more): the same table gives byte-identical
Audacity, Kaleidoscope and Raven files, including the stem collision, the
degraded INDIR, the duration fallbacks and the stale-label removal."""

from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import softspoken_tpu.export as jexport
from softspoken_tpu.io import wavio as jwavio
import softspoken_tpu_torch.export as export
from softspoken_tpu_torch.project import Table
from softspoken_tpu_torch.project.table import NAN


def _review_data(tmp_path):
    wavdir = tmp_path / "audio"
    wavdir.mkdir(exist_ok=True)
    for name, secs in [("rec1.wav", 10), ("rec2.wav", 5)]:
        jwavio.write(str(wavdir / name), np.zeros(22050 * secs, np.float32), 22050)
    return {
        "ID": [1, 2, 3],
        "file_path": [str(wavdir)] * 3,
        "file_name": ["rec1.wav", "rec1.wav", "rec2.wav"],
        "start_time": [1.25, 7.0, 0.5],
        "end_time": [2.75, 8.0, 1.0],
        "erase": [0, 1, 0],
        "user_comment": ["", "noisy, \"loud\"", ""],
        "review_datetime": ["", "2026-01-02 03:04:05", ""],
    }


def _frames(data):
    df = pd.DataFrame({k: [np.nan if v is NAN else v for v in vals] for k, vals in data.items()})
    return df, Table.from_columns(data)


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _run(tmp_path, data, call):
    """``call(package, table, base_dir)`` on both packages; their trees."""
    df, t = _frames(data)
    call(jexport, df, tmp_path / "jax")
    call(export, t, tmp_path / "port")
    return _tree(tmp_path / "port"), _tree(tmp_path / "jax")


def _standard(pkg, table, base):
    pkg.run_standard_exports(table, base, "proj")


def test_standard_exports_byte_identical(tmp_path):
    port, jax = _run(tmp_path, _review_data(tmp_path), _standard)
    assert sorted(port) == sorted(jax) == [
        "Audacity Outputs/proj/rec1.txt", "Audacity Outputs/proj/rec2.txt",
        "Kaleidoscope Outputs/proj/proj.csv", "Raven Outputs/proj/proj.txt",
        "Raven Outputs/proj/proj_listfile.txt"]
    assert port == jax


def test_review_normalized_table_byte_identical(tmp_path):
    """Integer times (an int64 column in pandas), a missing comment and an
    extra confidence column."""
    data = _review_data(tmp_path)
    data.update(start_time=[1, 7, 0], end_time=[3, 8, 1],
                user_comment=[NAN, "x", NAN], confidence=[0.5, NAN, 0.25])
    port, jax = _run(tmp_path, data, _standard)
    assert port == jax


def test_empty_table_byte_identical(tmp_path):
    data = {k: [] for k in _review_data(tmp_path)}
    port, jax = _run(tmp_path, data, _standard)
    assert port == jax and "Kaleidoscope Outputs/proj/proj.csv" in port


def _one(name, **kw):
    def call(pkg, table, base):
        cls = {"audacity": "AudacityTxtTransform", "kaleidoscope": "KaleidoscopeCsvTransform",
               "raven": "RavenTxtTransform"}[name]
        getattr(pkg, cls)()(table, base_dir=base, project_name="p", **kw)
    return call


CASES = {
    "kaleidoscope_folder_relpaths": ("kaleidoscope", {
        "file_path": ["/data/siteA", "/data/siteB/sub"], "file_name": ["a.wav", "b.wav"],
        "start_time": [0.0, 1.0], "end_time": [1.0, 2.0]}),
    "kaleidoscope_degraded_indir": ("kaleidoscope", {
        "file_path": ["rel/site", "/abs/site"], "file_name": ["a.wav", "b.wav"],
        "start_time": [0.0, 1.0], "end_time": [1.0, 2.0]}),
    "kaleidoscope_root_indir": ("kaleidoscope", {
        "file_path": ["/a", "/b"], "file_name": ["a.wav", "b.wav"],
        "start_time": [0.123456789, 1.0000005], "end_time": [1.0, 2.5]}),
    "raven_duration_fallback": ("raven", {
        "file_path": ["GHOST", "GHOST"], "file_name": ["ghost.wav", "ghost2.wav"],
        "start_time": [1.0, 2.0], "end_time": [4.0, 3.0]}),
    "raven_underivable_duration": ("raven", {
        "file_path": ["GHOST"] * 2, "file_name": ["ghost.wav", "later.wav"],
        "start_time": [1.0, 2.0], "end_time": ["corrupt", 3.0]}),
    "audacity_stem_collision": ("audacity", {
        "file_name": ["rec.wav", "rec.flac", "solo.wav", "sub/rec.wav"],
        "start_time": [1.0, 2.0, 3.0, 0.25], "end_time": [1.5, 2.5, 3.5, 0.5],
        "user_comment": ["", "", "", ""]}),
    "audacity_sorted_by_name_then_start": ("audacity", {
        "file_name": ["b.wav", "a.wav", "a.wav", "b.wav"],
        "start_time": ["2.5", "1", 0.5, "0.125"], "end_time": [3.0, 2, 0.75, 1]}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_transform_byte_identical(tmp_path, case):
    name, data = CASES[case]
    data = {k: [str(tmp_path) if v == "GHOST" else v for v in vals] for k, vals in data.items()}
    port, jax = _run(tmp_path, data, _one(name))
    assert port and port == jax


def test_audacity_nonnumeric_time_raises_the_same(tmp_path):
    data = _review_data(tmp_path)
    data["start_time"] = [1.25, "oops", 0.5]
    df, t = _frames(data)
    with pytest.raises(ValueError, match="non-numeric") as a:
        export.AudacityTxtTransform()(t, base_dir=tmp_path / "port", project_name="p")
    with pytest.raises(ValueError) as b:
        jexport.AudacityTxtTransform()(df, base_dir=tmp_path / "jax", project_name="p")
    assert str(a.value) == str(b.value)


def test_audacity_removes_stale_label_files_like_jax(tmp_path):
    data = _review_data(tmp_path)

    def call(pkg, table, base):
        t = pkg.AudacityTxtTransform()
        t(table, base_dir=base, project_name="p")
        keep = [i for i, n in enumerate(data["file_name"]) if n == "rec2.wav"]
        if isinstance(table, Table):
            table = Table(table.columns, [table.rows[i] for i in keep])
        else:
            table = table.iloc[keep]
        t(table, base_dir=base, project_name="p")

    port, jax = _run(tmp_path, data, call)
    assert port == jax and sorted(port) == ["Audacity Outputs/p/rec2.txt"]


def test_manager_dispatch_like_jax(tmp_path):
    class Upper(export.Transform):
        name = "upper"
        extension = ".txt"

        def __call__(self, table, **kw):
            return ",".join(str(v) for v in table.column("x")).upper()

    class AsTable(export.Transform):
        name = "table"

        def __call__(self, table, **kw):
            return Table.from_columns({"x": table.column("x"), "n": [1.5, NAN]})

    class SelfIO(export.Transform):
        name = "selfio"

        def __call__(self, table, **kw):
            return None

    mgr = export.ReviewExportManager(Table.from_columns({"x": ["a", "b"]}))
    for tf in (Upper(), AsTable(), SelfIO()):
        mgr.register_transform(tf)
    with pytest.raises(KeyError):
        mgr.register_transform(Upper())
    with pytest.raises(KeyError):
        mgr.export("nope", tmp_path)
    assert mgr.export("upper", tmp_path / "out.txt").read_text() == "A,B"
    assert mgr.export("selfio", tmp_path / "never.csv") is None
    assert not (tmp_path / "never.csv").exists()
    (tmp_path / "d").mkdir()
    path = mgr.export("table", tmp_path / "d")
    assert path == tmp_path / "d" / "review.csv"
    pd.DataFrame({"x": ["a", "b"], "n": [1.5, np.nan]}).to_csv(tmp_path / "pd.csv", index=False)
    assert path.read_bytes() == (tmp_path / "pd.csv").read_bytes()
    assert set(export.standard_manager(Table(["x"])).names()) == {
        "audacity", "kaleidoscope", "raven"}


def test_export_all_byte_identical(tmp_path):
    """``export_all`` over the standard manager: the same returned keys and
    paths (None: each stock exporter writes its own files) and trees."""
    out = {}

    def call(pkg, table, base):
        out[pkg.__name__] = pkg.standard_manager(table).export_all(
            base / "dst", base_dir=base, project_name="proj")

    port, jax = _run(tmp_path, _review_data(tmp_path), call)
    assert port == jax and len(port) == 5
    assert out["softspoken_tpu_torch.export"] == out["softspoken_tpu.export"] == {
        "audacity": None, "kaleidoscope": None, "raven": None}


def test_transform_decorator_byte_identical(tmp_path):
    """A transform registered with ``@manager.transform`` returns a table and
    a string; ``export_all`` writes them as the JAX manager does."""
    data = _review_data(tmp_path)
    paths = {}

    def call(pkg, table, base):
        mgr = pkg.ReviewExportManager(table)

        @mgr.transform
        class Erased(pkg.Transform):
            name = "erased"

            def __call__(self, t, **kw):
                if isinstance(t, Table):
                    return Table(t.columns, [r for r in t.rows if r["erase"] == 1])
                return t[t["erase"] == 1]

        @mgr.transform
        class Names(pkg.Transform):
            name = "names"
            extension = ".txt"

            def __call__(self, t, **kw):
                col = t.column("file_name") if isinstance(t, Table) else list(t["file_name"])
                return "\n".join(col) + "\n"

        assert isinstance(Erased, type) and mgr.names() == ["erased", "names"]
        with pytest.raises(KeyError):
            mgr.transform(Names)
        base.mkdir(parents=True)
        got = mgr.export_all(base)
        paths[pkg.__name__] = {k: v.relative_to(base) for k, v in got.items()}

    port, jax = _run(tmp_path, data, call)
    assert port == jax and sorted(port) == ["review.csv", "review.txt"]
    assert paths["softspoken_tpu_torch.export"] == paths["softspoken_tpu.export"]
