"""The port's profiling hooks (softspoken_tpu_torch/runtime/profiling.py) on
the CPU: ``device_trace`` writes a Chrome trace holding the ``annotate``d
spans, and ``annotate_function`` keeps the wrapped function's result and
name."""

import json

import pytest
import torch

from softspoken_tpu_torch.runtime.profiling import annotate, annotate_function, device_trace


def _events(log_dir):
    (path,) = list(log_dir.glob("*.json"))
    return json.loads(path.read_text())["traceEvents"]


def test_device_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    @annotate_function
    def product(a, b):
        return a @ b

    with device_trace(str(tmp_path / "trace"), device="cpu") as d:
        assert d == str(tmp_path / "trace")
        with annotate("softspoken.stage"):
            out = product(torch.ones(8, 8), torch.ones(8, 8))
    assert float(out[0, 0]) == 8.0
    names = {e.get("name") for e in _events(tmp_path / "trace")}
    assert "softspoken.stage" in names
    assert any(n and n.endswith("product") for n in names)
    assert any(n and "mm" in n for n in names)  # the op inside the span


def test_device_trace_default_dir_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("SOFTSPOKEN_TRACE_DIR", str(tmp_path / "env"))
    with device_trace(device="cpu") as d:
        with annotate("x"):
            torch.zeros(2).sum()
    assert d == str(tmp_path / "env")
    assert "x" in {e.get("name") for e in _events(tmp_path / "env")}


def test_annotate_function_keeps_result_and_name():
    def scale(x, k=2):
        """Doc."""
        return x * k

    wrapped = annotate_function(scale)
    assert wrapped(3) == 6 and wrapped(3, k=5) == 15
    assert wrapped.__name__ == "scale" and wrapped.__doc__ == "Doc."
    assert wrapped.__wrapped__ is scale
    named = annotate_function(scale, name="custom")
    assert named(4) == 8 and named.__name__ == "scale"


def test_annotate_is_a_context_manager_and_passes_errors():
    with pytest.raises(ValueError, match="inside"):
        with annotate("failing"):
            raise ValueError("inside")
