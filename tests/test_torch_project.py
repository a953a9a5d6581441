"""The port's project registry, detections store and pandas-free table
against the JAX package's ``project/`` and pandas itself: the same calls
give the same ``projects.json``, file lists, step status, legacy migration
and ID backfill; the table reads, coerces and writes CSV cells as pandas
does."""

import json
import os

import numpy as np
import pandas as pd
import pytest

from softspoken_tpu import Config as JConfig
from softspoken_tpu.project import ProjectManager as JManager
from softspoken_tpu.project import manager as jmanager_mod
from softspoken_tpu.project.store import DetectionStore as JStore
from softspoken_tpu.project.store import backfill_ids as jbackfill
from softspoken_tpu_torch import Config
from softspoken_tpu_torch.project import (COLUMNS, DetectionProject, DetectionStore,
                                          ProjectManager, Table, backfill_ids,
                                          empty_detections_table, read_csv, to_numeric,
                                          write_csv)
from softspoken_tpu_torch.project import manager as manager_mod
from softspoken_tpu_torch.project import table as table_mod

@pytest.fixture
def pinned_clock(monkeypatch):
    """One clock for both packages: every call returns the next stamp, and
    each package's sequence is replayed from the same start."""
    stamps = [f"2026-01-{d:02d} {h:02d}:00:00" for d in range(1, 28) for h in range(24)]
    for mod in (manager_mod, jmanager_mod):
        it = iter(stamps)
        monkeypatch.setattr(mod, "_now_str", lambda it=it: next(it))


def _both(tmp_path):
    port = ProjectManager(Config().with_paths(project_dir=str(tmp_path / "port")))
    jax = JManager(JConfig().with_paths(project_dir=str(tmp_path / "jax")))
    return port, jax


def _registry(pm, root):
    with open(pm.projects_file) as f:
        return f.read().replace(str(root), "<ROOT>")


def _script(pm):
    """One sequence of manager calls; returns what each call gave."""
    got = [pm.add_project("alpha"), pm.add_project("beta")]
    for bad in ("../x", "a/b", "a\\b", "..", ".", "", "alpha"):
        with pytest.raises(ValueError):
            pm.add_project(bad)
    with pytest.raises(RuntimeError):
        pm.update_file_list(["/a.wav"])
    got.append(pm.set_active_project("alpha"))
    got.append(pm.step_status())
    got.append(pm.update_file_list(["/r/b.wav", "/r/a.wav", "/r/b.wav"]))
    got.append(pm.update_file_list(["/r/c.wav"]))
    got.append(pm.remove_from_file_list(["/r/a.wav", "/r/zz.wav"]))
    got.append(pm.get_unprocessed_list())
    with open(pm.current_project["detections_file"], "w") as f:
        f.write("ID\n1\n")
    open(pm.current_project["review_file"], "w").close()
    got.append(pm.step_status())
    pm.current_project["silence_status_file"] = os.path.join(pm.projects_folder, "s.txt")
    pm.save_current_project()
    got.append(pm.set_active_project("nope"))
    got.append(pm.activate_latest())
    got.append(pm.current_project["name"])
    got.append(pm.list_projects_by_name())
    return got


def test_manager_sequence_equals_the_jax_manager(tmp_path, pinned_clock):
    port, jax = _both(tmp_path)
    a, b = _script(port), _script(jax)
    norm = lambda v, root: json.loads(json.dumps(v).replace(str(root), "<ROOT>"))
    assert norm(a, tmp_path / "port") == norm(b, tmp_path / "jax")
    assert _registry(port, tmp_path / "port") == _registry(jax, tmp_path / "jax")
    with open(port.current_project["file_list_file"]) as f1, \
            open(jax.current_project["file_list_file"]) as f2:
        assert f1.read() == f2.read()
    # a fresh manager reads the registry back the same way
    port2, jax2 = _both(tmp_path)
    assert port2.list_projects_by_name() == jax2.list_projects_by_name() == ["alpha", "beta"]


def _legacy(root):
    pdir = root / "projects"
    pdir.mkdir(parents=True)
    (pdir / "old_detections.csv").write_text("ID,file_path\n1,/x\n")
    (pdir / "stray_files.txt").write_text("/x/a.wav\n")
    registry = [
        {"name": "mig", "file_list_file": str(pdir / "stray_files.txt"),
         "detections_file": str(pdir / "old_detections.csv"),
         "review_file": str(pdir / "gone.csv"), "last_accessed": "2023-01-01 00:00:00"},
        {"detections_file": "/nowhere.csv"},  # nameless: skipped, kept
    ]
    (pdir / "projects.json").write_text(json.dumps(registry))
    return str(pdir)


def test_legacy_migration_equals_the_jax_manager(tmp_path):
    port = ProjectManager(Config().with_paths(project_dir=_legacy(tmp_path / "port")))
    jax = JManager(JConfig().with_paths(project_dir=_legacy(tmp_path / "jax")))
    assert _registry(port, tmp_path / "port") == _registry(jax, tmp_path / "jax")
    for root in ("port", "jax"):
        out = tmp_path / root / "projects" / "Softspoken Outputs" / "mig"
        assert sorted(os.listdir(out)) == ["mig_detections.csv", "mig_files.txt"]
        assert not (tmp_path / root / "projects" / "old_detections.csv").exists()
    assert port.list_projects_by_name() == jax.list_projects_by_name() == ["mig"]


BACKFILL = {
    "no_id_column": {"file_path": ["/x", "/x", "/x"], "file_name": ["a", "b", "c"]},
    "gaps": {"ID": [5, None, None, 2], "file_name": ["a", "b", "c", "d"]},
    "strings": {"ID": ["3", "", "x", " 7", "2.9"], "file_name": list("abcde")},
    "all_missing": {"ID": [None, None], "file_name": ["a", "b"]},
    "floats": {"ID": [1.0, 2.5, None], "file_name": ["a", "b", "c"]},
    "empty": {"ID": [], "file_name": []},
}


def _cells(v):
    return table_mod.NAN if v is None else v


@pytest.mark.parametrize("case", sorted(BACKFILL))
def test_backfill_ids_equals_the_jax_function(case):
    data = BACKFILL[case]
    jdf = jbackfill(pd.DataFrame({k: pd.Series(v, dtype=object) for k, v in data.items()}))
    t = backfill_ids(Table.from_columns({k: [_cells(x) for x in v] for k, v in data.items()}))
    assert t.columns == list(jdf.columns)
    assert t.column("ID") == jdf["ID"].tolist()
    assert all(type(i) is int for i in t.column("ID"))


def test_store_api_and_files_equal_the_jax_store(tmp_path):
    proj = {"detections_file": str(tmp_path / "p.csv")}
    jproj = {"detections_file": str(tmp_path / "j.csv")}
    s, js = DetectionProject.for_project(proj), JStore.for_project(jproj)
    assert isinstance(s, DetectionStore) and s.path == proj["detections_file"]
    for store in (s, js):
        store.append_intervals("/rec/a.wav", [(1.25, 2.5), (-3.0, 0.1 + 0.2)])
        store.save()
        store.mark_processed("/rec/quiet.wav")
    assert open(proj["detections_file"]).read() == open(jproj["detections_file"]).read()
    again, jagain = DetectionStore(proj["detections_file"]), JStore(jproj["detections_file"])
    assert again.processed_files() == jagain.processed_files()
    assert again.next_id() == jagain.next_id() == 3
    assert empty_detections_table().columns == COLUMNS == list(jagain.df.columns)
    assert len(empty_detections_table()) == 0


# ---- pandas semantics --------------------------------------------------

COERCE = ["1", "1.0", "", "yes", "0", " 1", "1 ", "nan", "NA", "None", "inf", "-Infinity",
          "+2", ".5", "5.", "1e3", "1_0", "0x10", "True", "  ", "2.5e-7"]


@pytest.mark.parametrize("v", COERCE + [float("nan"), 1, 1.0, 3.5])
def test_to_numeric_coerce_equals_pandas(v):
    want = pd.to_numeric(pd.Series([v], dtype=object), errors="coerce")
    got = to_numeric([v])
    assert len(got) == 1
    if np.isnan(want.iloc[0]):
        assert table_mod.is_na(got[0])
    else:
        assert got[0] == want.iloc[0]
        assert isinstance(got[0], int) == (want.dtype.kind == "i")
    assert (table_mod.to_number(v) == 1) == bool(want.iloc[0] == 1)


MIXED_CSV = (
    "i,f,e,s,b,n,w,q,z\n"
    "1,1.0,,x,True,0,\" 1\",\"a,b\",1e400\n"
    "2,2,,,false,1,2 ,\"say \"\"hi\"\"\",-inf\n"
    "-3,1e3,,y,True,,3.5,,5\n"
)


@pytest.mark.parametrize("kna", [True, False])
def test_read_csv_infers_types_as_pandas(tmp_path, kna):
    p = tmp_path / "m.csv"
    p.write_text(MIXED_CSV)
    df = pd.read_csv(p, keep_default_na=kna)
    t = read_csv(str(p), keep_default_na=kna)
    assert t.columns == list(df.columns)
    for c in df.columns:
        want = df[c].tolist()
        got = t.column(c)
        for a, b in zip(got, want):
            if isinstance(b, float) and np.isnan(b):
                assert table_mod.is_na(a), (c, got, want)
            else:
                assert a == b and type(a) is type(b), (c, got, want)
    # and writes it back as pandas does
    a, b = tmp_path / "port.csv", tmp_path / "pd.csv"
    write_csv(str(a), t)
    df.to_csv(b, index=False)
    assert a.read_bytes() == b.read_bytes()


WRITE_CASES = {
    "ints": {"a": [1, 2, 3]},
    "floats": {"a": [0.1, 1e16, 1e-5, 123456789.123456789, 1 / 3, 2.5e-7, 1e15, -0.0]},
    "int_and_nan": {"a": [1, None, 3], "b": ["x", "y", "z"]},
    "object": {"a": ["corrupt", 3.0, 2], "b": [None, "", "q\"uote"]},
    "newline": {"a": ["two\nlines", "tab\there", "comma,here"]},
    "one_empty_column": {"a": ["", None, "x"]},
    "bools": {"a": [True, False, True], "b": [True, None, False]},
    "empty": {"a": [], "b": []},
}


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
@pytest.mark.parametrize("sep", [",", "\t"])
def test_write_csv_bytes_equal_pandas(tmp_path, case, sep):
    data = WRITE_CASES[case]
    df = pd.DataFrame({k: (v if all(x is not None for x in v) or not v
                           else [np.nan if x is None else x for x in v])
                       for k, v in data.items()})
    a, b = tmp_path / "port.csv", tmp_path / "pd.csv"
    write_csv(str(a), Table.from_columns({k: [_cells(x) for x in v] for k, v in data.items()}),
              sep=sep)
    df.to_csv(b, index=False, sep=sep, lineterminator="\n")
    assert a.read_bytes() == b.read_bytes()


def test_sort_rows_equals_sort_values():
    data = {"file_name": ["b", "a", "a", "b", "a", "c"],
            "start_time": [1.0, np.nan, 0.5, 1.0, 0.5, -2.0],
            "tag": [0, 1, 2, 3, 4, 5]}
    want = pd.DataFrame(data).sort_values(["file_name", "start_time"])["tag"].tolist()
    rows = Table.from_columns(data).rows
    assert [r["tag"] for r in table_mod.sort_rows(rows, ["file_name", "start_time"])] == want
