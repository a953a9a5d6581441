"""Whole runs of the detection cells at a small size on the CPU: a sound run
is correct; the control and each fault the cells can have are not.

The faults break the timed path underneath the harness: the chunk program
returns its carry unchanged (the grid's state between chunks), half of each
chunk's windows are left out and the grid averaged over the rest, and one
answer is altered where the engine produces it."""

import numpy as np
import pytest

import benchcopy

from benchmarks import run
from benchmarks.harness import registry

CELLS = benchcopy.cells("detect_runner")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return benchcopy.tiny_copy(str(tmp_path_factory.mktemp("bench")))


def _run(root, cell, hook=None, trace=False, seed=2**31 + 3):
    result, checks = run.run_cell(cell, seed, 2.0, trace, device="cpu", root=root,
                                  driver_hook=hook)
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(root, cell):
    r = _run(root, cell)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    cell_metrics = {m["name"] for m in registry.find_cell(cell).end_to_end}
    assert set(r["metrics"]) == cell_metrics and "setup_s" in cell_metrics
    assert list(r)[-1] == "checks"


def test_a_traced_run_reports_the_per_layer_metrics(root):
    r = _run(root, CELLS[0], trace=True)
    assert r["correct"] is True, r["checks"]
    assert {"runner.persist_ms_per_file", "fused.dispatch_pct", "fused.wait_prepare_pct",
            "mfu.detect"} <= set(r["metrics"])
    assert r["device"]["window_s"] > 0
    assert "device_ops" in r["breakdown"] and "idle_gaps" in r["breakdown"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(root, cell):
    r = _run(root, cell, hook=lambda d: d.use_control(d.cell.config["control"]))
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    r = _run(root, CELLS[0], hook=lambda d: d.plant_fault(fault, monkeypatch.setattr))
    assert r["correct"] is False, r["checks"]
    failing = [k for k, c in r["checks"].items() if not run.check_passes(dict(c, name=k))]
    assert failing


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run.set_cache_env()
    r, _ = run.run_cell(cell, 2**31 + 5, 2.0, False)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0
    assert all(np.isfinite(m["value"]) for m in r["metrics"].values())
