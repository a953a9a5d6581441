"""The readers of the program's spans and counters (``metrics/``
``batch.fill_pct.files``, ``fused.device_wait_pct[.files]``,
``fused.batch_enqueue_pct``) on synthetic records, the cells they apply
to, and a traced run of each detection cell at a small size on the CPU."""

import pytest

import benchcopy

from benchmarks import run
from benchmarks.harness import registry

NEW = ("batch.fill_pct.files", "fused.device_wait_pct.files", "fused.device_wait_pct",
       "fused.batch_enqueue_pct")


def _read(name, records):
    return registry.load_module("metrics", name).read(records)


def _records(wall_s=2.0, **timers):
    return {"window": {"wall_s": wall_s, "files": [("a", 0.0, 1.0, 60.0)], "timers": timers}}


def test_the_fill_is_the_live_share_of_the_launched_slots():
    rec = _records(**{"count.windows_live": 105.0, "count.windows_launched": 256.0,
                      "dispatch": 0.5})
    assert _read("batch.fill_pct.files", rec) == pytest.approx(100.0 * 105 / 256)
    assert _read("batch.fill_pct.files", _records(**{"count.windows_live": 4.0,
                                                     "count.windows_launched": 4.0})) == 100.0


@pytest.mark.parametrize("records", [
    {}, {"window": None}, _records(), _records(dispatch=1.0),
    _records(**{"count.windows_live": 0.0, "count.windows_launched": 0.0}),
    _records(**{"count.windows_launched": 256.0}),
], ids=["no-window", "window-none", "no-timers", "no-counters", "nothing-launched",
        "no-live-count"])
def test_the_fill_reads_nothing_where_the_program_counts_nothing(records):
    assert _read("batch.fill_pct.files", records) is None


@pytest.mark.parametrize("name, stage", [
    ("fused.device_wait_pct.files", "device_wait"),
    ("fused.device_wait_pct", "device_wait"),
    ("fused.batch_enqueue_pct", "chunk.batch"),
])
def test_a_span_share_is_its_seconds_over_the_window(name, stage):
    assert _read(name, _records(wall_s=4.0, **{stage: 1.0, "dispatch": 3.0})) == 25.0
    # the parent's program has no such span: nothing to read
    assert _read(name, _records(wall_s=4.0, dispatch=3.0, final_fetch=1.0)) is None
    assert _read(name, _records(wall_s=0.0, **{stage: 1.0})) is None
    assert _read(name, {}) is None


def test_each_metric_applies_to_the_cells_of_what_it_moves():
    per_cell = {w["name"]: {m["name"] for m in registry.find_cell(w["name"]).per_layer}
                for w in registry.load_spec()["workloads"]}
    assert {"batch.fill_pct.files", "fused.device_wait_pct.files"} <= per_cell["detect-short-wav"]
    assert {"fused.device_wait_pct", "fused.batch_enqueue_pct"} <= per_cell["detect-long-wav"]
    assert per_cell["detect-short-wav"].isdisjoint({"fused.device_wait_pct",
                                                    "fused.batch_enqueue_pct"})
    assert per_cell["detect-long-wav"].isdisjoint({"batch.fill_pct.files",
                                                   "fused.device_wait_pct.files"})
    assert per_cell["train-synth-r05"].isdisjoint(NEW)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return benchcopy.tiny_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell", benchcopy.cells("detect_runner"))
def test_a_traced_run_reports_the_new_metrics(root, cell):
    windows = []

    def keep_windows(driver):
        inner = driver.window

        def window(*args, **kwargs):
            windows.append(inner(*args, **kwargs))
            return windows[-1]

        driver.window = window

    r, _ = run.run_cell(cell, 2**31 + 11, 2.0, True, device="cpu", root=root,
                        driver_hook=keep_windows)
    assert r["correct"] is True, r["checks"]
    mine = {m["name"] for m in registry.find_cell(cell, root).per_layer} & set(NEW)
    assert mine and mine <= set(r["metrics"])
    for name in mine:
        assert 0.0 < r["metrics"][name]["value"] <= 100.0
    # the program counts every window the benchmark's frozen count does
    assert len(windows) == 2
    for w in windows:
        assert w["timers"]["count.windows_live"] == w["windows"] > 0
    if "batch.fill_pct.files" in mine:
        # every recording of the mix has one length: chunks of 8 slots (the
        # small copy's device batch, 4.8 s a chunk)
        live = windows[0]["windows"] / len(windows[0]["files"])
        assert r["metrics"]["batch.fill_pct.files"]["value"] == pytest.approx(
            100.0 * live / (-(-live // 8) * 8))
