"""The port's spans and counters (``runtime/metrics.py::StageTimers``) on the
CPU: totals and counters added from many threads at once; no
``record_function`` while no profiler is active; under ``device_trace``,
the detect path's spans on the threads that do the work, each carrying its
file's index; the fused engine's window counters against the planner; and
the CLI's closing JSON, which keeps counts apart from seconds."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from softspoken_tpu_torch import Config, cli
from softspoken_tpu_torch.ckpt import fixture_state_dict
from softspoken_tpu_torch.engine import Detector
from softspoken_tpu_torch.engine.fused import get_fused_engine
from softspoken_tpu_torch.engine.planner import num_windows_for_padded_length
from softspoken_tpu_torch.io import wavio
from softspoken_tpu_torch.project import DetectionStore
from softspoken_tpu_torch.runtime import DetectRunner, StageTimers
from softspoken_tpu_torch.runtime.metrics import count, recording, span
from softspoken_tpu_torch.runtime.profiling import device_trace

torch.set_num_threads(2)

# two batches of 2 windows a chunk (chunk_w 4), so batches nest in dispatch
ENG = dict(precision="parity", device_batch=2, chunk_seconds=3.0, pipeline="fused")
SR = 48000  # resampled to the model's rate on the device, as the short cell


def _wavs(tmp_path, seconds, sr=SR):
    rng = np.random.default_rng(5)
    paths = []
    for i, secs in enumerate(seconds):
        p = str(tmp_path / f"t{i}.wav")
        wavio.write(p, rng.uniform(-0.4, 0.4, int(sr * secs)).astype(np.float32), sr,
                    subtype="PCM_16")
        paths.append(p)
    return paths


def _runner(tmp_path, name="d.csv"):
    cfg = Config().with_engine(**ENG)
    det = Detector(cfg, state_dict=fixture_state_dict(0), device="cpu")
    return DetectRunner(det, DetectionStore(str(tmp_path / name)), cfg, streaming=True)


def _planned_windows(runner, path):
    """The planner's window count for ``path`` as the fused engine pads it."""
    info = wavio.info(path)
    eng = get_fused_engine(runner.detector, info.samplerate, "i16")
    cfg = runner.cfg
    padded = info.frames + 2 * int(round(cfg.engine.pad_seconds * info.samplerate))
    return num_windows_for_padded_length(-(-padded * eng.up // eng.down), cfg), eng


def test_totals_and_counters_from_many_threads_at_once():
    timers = StageTimers()
    n_threads, n_each = 16, 200
    start = threading.Barrier(n_threads)

    def work(k):
        start.wait(timeout=30)
        with recording(timers, k):
            for _ in range(n_each):
                timers.add("fill", 0.5)
                with timers.time("span"):
                    pass
                with span("deep"):
                    pass
                count("windows", 3)
                timers.count("chunks")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    total = n_threads * n_each
    s = timers.summary()
    assert s["fill"] == 0.5 * total
    assert s["count.windows"] == 3.0 * total and s["count.chunks"] == float(total)
    assert timers.calls["span"] == timers.calls["deep"] == timers.calls["fill"] == total
    assert s["span"] >= 0.0 and s["deep"] >= 0.0
    assert all(isinstance(v, float) for v in s.values())
    assert timers.seconds() == {k: v for k, v in s.items() if not k.startswith("count.")}
    assert timers.counted() == {"windows": 3 * total, "chunks": total}


def test_a_span_records_its_time_when_the_block_raises():
    timers = StageTimers()
    with pytest.raises(ValueError):
        with timers.time("failing"):
            raise ValueError("inside")
    assert timers.calls["failing"] == 1 and timers.totals["failing"] >= 0.0


def test_spans_outside_a_recorder_count_nothing():
    with span("nowhere"):
        pass
    count("nowhere")  # no recorder bound on this thread: a no-op
    timers = StageTimers()
    with recording(timers, 1):
        with recording(None):
            count("inner")
        count("outer")
    assert timers.counted() == {"outer": 1}


def test_no_record_function_is_made_without_a_profiler(tmp_path, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a record_function was made with no profiler active")

    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter", refuse)
    monkeypatch.setattr(torch.profiler.record_function, "__enter__", refuse)
    (wav,) = _wavs(tmp_path, [4])
    runner = _runner(tmp_path)
    rep = runner.run([wav])
    assert rep.errors == {} and rep.files_done == 1
    assert {"probe", "dispatch", "chunk.batch", "device_wait", "fetch", "regions",
            "persist"} <= set(rep.timers)


def _spans(trace_dir):
    (path,) = list(trace_dir.glob("*.json"))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_device_trace_holds_every_threads_spans_with_the_file_index(tmp_path):
    paths = _wavs(tmp_path, [4, 6])
    runner = _runner(tmp_path)
    main_tid = threading.get_native_id()
    with device_trace(str(tmp_path / "trace"), device="cpu"):
        rep = runner.run(paths)
    assert rep.errors == {} and rep.files_done == 2
    spans = _spans(tmp_path / "trace")
    by = {}
    for e in spans:
        by.setdefault(e["name"], []).append(e)
    names = ("dispatch", "chunk.batch", "chunk.decode", "chunk.grid", "host_fill",
             "device_put", "wait_prepare", "device_wait", "fetch", "regions", "probe",
             "persist", "detect")
    assert set(names) <= set(by), sorted(by)

    for index in (0, 1):
        def tid(name):
            tids = {e["tid"] for e in by[name]
                    if e["args"].get("Concrete Inputs") == [str(index)]}
            assert len(tids) == 1, (name, index, tids)
            return tids.pop()

        worker = tid("dispatch")
        for name in ("chunk.batch", "chunk.decode", "chunk.grid", "wait_prepare",
                     "device_wait", "fetch", "regions", "probe", "detect"):
            assert tid(name) == worker, name
        fill, upload = tid("host_fill"), tid("device_put")
        assert len({worker, fill, upload, main_tid}) == 4
        assert tid("persist") == main_tid
    # every span carries a file's index
    assert all(e["args"].get("Concrete Inputs") in (["0"], ["1"]) for e in spans)
    # each batch nests in a dispatch on its thread, and there is one a batch
    for b in by["chunk.batch"]:
        assert any(d["tid"] == b["tid"] and d["ts"] <= b["ts"]
                   and b["ts"] + b["dur"] <= d["ts"] + d["dur"] for d in by["dispatch"])
    assert len(by["chunk.batch"]) == rep.counts["batches"] == runner.timers.calls["chunk.batch"]
    assert len(by["dispatch"]) == rep.counts["chunks"]


def test_window_counters_follow_the_planner(tmp_path):
    paths = _wavs(tmp_path, [4, 6, 2.5])
    runner = _runner(tmp_path)
    rep = runner.run(paths)
    assert rep.errors == {} and rep.files_done == 3
    planned = [_planned_windows(runner, p) for p in paths]
    eng = planned[0][1]
    assert eng.chunk_w == 4 and eng.nb == 2
    chunks = sum(-(-n // eng.chunk_w) for n, _ in planned)
    assert rep.counts == {"chunks": chunks, "batches": chunks * eng.nb,
                          "windows_live": sum(n for n, _ in planned),
                          "windows_launched": chunks * eng.chunk_w}
    s = runner.timers.summary()
    assert s["count.windows_live"] == float(sum(n for n, _ in planned))
    assert set(rep.timers).isdisjoint({f"count.{k}" for k in rep.counts})


def test_the_cli_prints_counts_apart_from_seconds(tmp_path, capsys):
    (wav,) = _wavs(tmp_path, [4])
    conf = tmp_path / "c.json"
    conf.write_text(json.dumps({"engine": ENG}))
    assert cli.main(["detect", "--files", wav, "--out", str(tmp_path / "d.csv"),
                     "--random-init", "--device", "cpu", "--config", str(conf)]) == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.rindex("\n{") + 1:])
    n, eng = _planned_windows(_runner(tmp_path, "x.csv"), wav)
    assert report["counts"]["windows_live"] == n
    assert report["counts"]["windows_launched"] == -(-n // eng.chunk_w) * eng.chunk_w
    assert not any(k.startswith("count") for k in report["stage_seconds"])
    assert {"probe", "dispatch", "persist"} <= set(report["stage_seconds"])
