"""The port's profiling hooks (softspoken_tpu_torch/runtime/profiling.py) on
the CPU: ``device_trace`` writes a Chrome trace holding the ``annotate``d
spans, those of every thread, into ``$SOFTSPOKEN_TRACE_DIR`` or else under
the temporary directory; ``annotate`` passes errors on."""

import json
import os
import tempfile
import threading

import pytest
import torch

from softspoken_tpu_torch.runtime.profiling import annotate, device_trace


def _events(log_dir):
    (path,) = list(log_dir.glob("*.json"))
    return json.loads(path.read_text())["traceEvents"]


def test_device_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    def product(a, b):
        with annotate("softspoken.product"):
            return a @ b

    with device_trace(str(tmp_path / "trace"), device="cpu") as d:
        assert d == str(tmp_path / "trace")
        with annotate("softspoken.stage"):
            out = product(torch.ones(8, 8), torch.ones(8, 8))
    assert float(out[0, 0]) == 8.0
    names = {e.get("name") for e in _events(tmp_path / "trace")}
    assert {"softspoken.stage", "softspoken.product"} <= names
    assert any(n and "mm" in n for n in names)  # the op inside the span


def test_device_trace_default_dir_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.delenv("SOFTSPOKEN_TRACE_DIR", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    os.makedirs(tmp_path / "tmp")
    monkeypatch.setattr(tempfile, "tempdir", None)  # read $TMPDIR again
    with device_trace(device="cpu") as d:
        with annotate("x"):
            torch.zeros(2).sum()
    assert d == str(tmp_path / "tmp" / "softspoken_trace")
    assert "x" in {e.get("name") for e in _events(tmp_path / "tmp" / "softspoken_trace")}

    monkeypatch.setenv("SOFTSPOKEN_TRACE_DIR", str(tmp_path / "env"))
    with device_trace(device="cpu") as d:
        with annotate("y"):
            torch.zeros(2).sum()
    assert d == str(tmp_path / "env")
    assert "y" in {e.get("name") for e in _events(tmp_path / "env")}


def test_device_trace_holds_a_worker_threads_span(tmp_path):
    tids = []

    def work():
        tids.append(threading.get_native_id())
        with annotate("softspoken.worker"):
            torch.ones(4, 4).sum()

    with device_trace(str(tmp_path / "trace"), device="cpu"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=60)
    assert not t.is_alive()
    spans = [e for e in _events(tmp_path / "trace") if e.get("name") == "softspoken.worker"]
    assert [e["tid"] for e in spans] == tids != [threading.get_native_id()]


def test_annotate_is_a_context_manager_and_passes_errors():
    with pytest.raises(ValueError, match="inside"):
        with annotate("failing"):
            raise ValueError("inside")
