"""Detection run orchestration (GUI-decoupled).

The role of the reference's Qt worker thread (``worker.py:21-139``): per
file, detect → append rows → save the CSV (the reference's per-file resume
checkpoint).  Files already in the CSV are skipped when
``cfg.engine.skip_processed_files``; a failed file is retried once and then
recorded in ``RunReport.errors`` without stopping the run, so callers must
check ``errors``.  Files are detected and persisted one after another
(``file_concurrency`` 1).

Which decode a file gets follows the JAX package's runner, with the CUDA
card in place of its TPU: the fused pipeline always streams; otherwise a
file streams only above 1 GiB, and smaller files are decoded in memory by a
one-deep prefetch thread, so file i+1's decode overlaps file i's detection.
``streaming=True`` (the CLI's ``--streaming``) forces streaming.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Optional

from ..config import Config, DEFAULT_CONFIG
from ..engine import Detector
from ..io import load_audio
from ..project.store import DetectionStore
from .metrics import StageTimers, ThroughputMeter

STREAM_ABOVE_BYTES = 1 << 30  # files larger than this stream on the host pipeline


@dataclass
class RunCallbacks:
    file_started: Optional[Callable[[str], None]] = None
    file_progress: Optional[Callable[[float], None]] = None   # 0..100
    file_done: Optional[Callable[[str], None]] = None
    overall_progress: Optional[Callable[[float], None]] = None
    message: Optional[Callable[[str], None]] = None
    finished: Optional[Callable[[], None]] = None

    def emit(self, name: str, *args) -> None:
        cb = getattr(self, name)
        if cb is not None:
            cb(*args)


@dataclass
class RunReport:
    files_done: int = 0      # successful completions only
    files_skipped: int = 0
    rows_added: int = 0
    errors: Dict[str, str] = field(default_factory=dict)
    stopped: bool = False
    throughput: Dict[str, float] = field(default_factory=dict)
    timers: Dict[str, float] = field(default_factory=dict)


class DetectRunner:
    """Run detection over a list of files into a DetectionStore."""

    def __init__(self, detector: Detector, store: DetectionStore,
                 config: Config = DEFAULT_CONFIG, streaming: Optional[bool] = None):
        if config.engine.file_concurrency != 1:
            raise NotImplementedError(
                "file_concurrency > 1 is not ported to softspoken_tpu_torch yet")
        self.detector = detector
        self.store = store
        self.cfg = config
        self.streaming = streaming  # None: by pipeline and file size
        self._stop = threading.Event()
        self.meter = ThroughputMeter()
        self.timers = StageTimers()

    def stop(self) -> None:
        """Stop between files (the file in progress completes)."""
        self._stop.set()

    def _use_streaming(self, path: str) -> bool:
        if self.streaming is not None:
            return self.streaming
        if self.detector.pipeline == "fused":
            return True
        try:
            return os.path.getsize(path) > STREAM_ABOVE_BYTES
        except OSError:
            return False

    def _prepare(self, path: str):
        """None for a file that streams, else its decoded waveform (runs on
        the prefetch thread).  Raises IOError when the decode fails."""
        if self._use_streaming(path):
            return None
        with self.timers.time("decode"):
            audio, _sr = load_audio(path, target_sr=self.cfg.dsp.sample_rate)
        if audio is None:
            raise IOError(f"failed to decode {path}")
        return audio

    def _detect(self, path: str, audio, cb: RunCallbacks):
        def progress(frac):
            cb.emit("file_progress", frac * 100.0)

        with self.timers.time("detect"):
            if audio is None:
                return self.detector.detect_file_streaming(path, progress,
                                                           timers=self.timers)
            return self.detector.detect_waveform(audio, progress, timers=self.timers)

    def run(self, files: Iterable[str],
            callbacks: Optional[RunCallbacks] = None) -> RunReport:
        cb = callbacks or RunCallbacks()
        report = RunReport()
        files = list(dict.fromkeys(files))  # a path listed twice runs once
        total = len(files)
        self.meter.reset()
        already = self.store.processed_files() if self.cfg.engine.skip_processed_files else set()
        todo = iter([p for p in files if p not in already])
        prefetch = ThreadPoolExecutor(max_workers=1)
        decoded: Dict[str, Future] = {}

        def prefetch_next() -> None:
            path = next(todo, None)
            if path is not None:
                decoded[path] = prefetch.submit(self._prepare, path)

        try:
            prefetch_next()
            for path in files:
                if self._stop.is_set():
                    report.stopped = True
                    break
                if path in already:
                    report.files_skipped += 1
                    cb.emit("message", f"skipping already-processed {path}")
                else:
                    fut = decoded.pop(path)
                    prefetch_next()  # the next decode overlaps this detection
                    self._one(path, fut, cb, report)
                advanced = report.files_done + report.files_skipped + len(report.errors)
                cb.emit("overall_progress", advanced / max(1, total) * 100.0)
        finally:
            # a decode not yet started is dropped; one in progress completes
            prefetch.shutdown(wait=True, cancel_futures=True)
            report.throughput = self.meter.summary()
            report.timers = self.timers.summary()
            cb.emit("finished")
        return report

    def _one(self, path: str, fut: Future, cb: RunCallbacks, report: RunReport) -> None:
        cb.emit("file_started", path)
        try:
            audio = fut.result()
            try:
                result = self._detect(path, audio, cb)
            except (IOError, NotImplementedError, ValueError):
                raise  # unreadable or unsupported input: a retry cannot help
            except Exception as e:  # noqa: BLE001 — one retry for a transient fault
                cb.emit("message", f"retrying {path} after: {e!r}")
                result = self._detect(path, audio, cb)
        except Exception as e:  # noqa: BLE001 — recorded; the run goes on
            report.errors[path] = f"{type(e).__name__}: {e}"
            cb.emit("message", f"detection failed for {path}: {e!r}")
            return
        with self.timers.time("persist"):
            report.rows_added += self.store.append_intervals(path, result.intervals)
            self.store.save()  # per-file checkpoint (worker.py:128)
            self.store.mark_processed(path)
        self.meter.add_audio(result.audio_seconds)
        report.files_done += 1
        cb.emit("file_done", path)
        cb.emit("message", f"{path}: {len(result.intervals)} region(s); "
                           f"{self.meter.audio_sec_per_wall_sec:.1f} audio-sec/sec")
