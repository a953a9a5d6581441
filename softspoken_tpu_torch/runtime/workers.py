"""Detection run orchestration (GUI-decoupled).

The role of the reference's Qt worker thread (``worker.py:21-139``): per
file, detect → append rows → save the CSV (the reference's per-file resume
checkpoint).  Files already in the CSV are skipped when
``cfg.engine.skip_processed_files``; a failed file is retried once and then
recorded in ``RunReport.errors`` without stopping the run, so callers must
check ``errors``.

``engine.file_concurrency`` = K detects up to K files at once on worker
threads (so one file's host decode overlaps another's); this thread settles
the results strictly in submission order, so the CSV rows and the store's
single writer are those of the sequential run.  Per-file progress and
message callbacks may then fire from worker threads and interleave.  With
``engine.chunk_checkpoint_every`` > 0 the fused pipeline journals each
file's chunk progress in ``.chunk_progress/`` next to the detections CSV,
and a killed run resumes mid-file.

Which decode a file gets follows the JAX package's runner, with the CUDA
card in place of its TPU: the fused pipeline always streams; otherwise a
file streams only above 1 GiB, and smaller files are decoded in memory by a
one-deep prefetch thread, so file i+1's decode overlaps file i's detection.
``streaming=True`` (the CLI's ``--streaming``) forces streaming.
"""

from __future__ import annotations

import os
import threading
from collections import deque
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
        if config.engine.file_concurrency < 1:
            raise ValueError(f"file_concurrency must be >= 1, got "
                             f"{config.engine.file_concurrency}")
        self.detector = detector
        self.store = store
        self.cfg = config
        self.streaming = streaming  # None: by pipeline and file size
        self._stop = threading.Event()
        self.meter = ThroughputMeter()
        self.timers = StageTimers()

    def stop(self) -> None:
        """Stop between files: no new file starts, and the files in flight
        complete and are settled."""
        self._stop.set()

    def journal_dir(self) -> Optional[str]:
        """Where chunk journals live: ``.chunk_progress/`` next to the
        detections CSV, when ``engine.chunk_checkpoint_every`` > 0."""
        if self.cfg.engine.chunk_checkpoint_every <= 0:
            return None
        return os.path.join(os.path.dirname(os.path.abspath(self.store.path)),
                            ".chunk_progress")

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

    def _detect(self, path: str, audio, cb: RunCallbacks, journal_dir: Optional[str]):
        def progress(frac):
            cb.emit("file_progress", frac * 100.0)

        with self.timers.time("detect"):
            if audio is None:
                return self.detector.detect_file_streaming(path, progress, journal_dir,
                                                           timers=self.timers)
            return self.detector.detect_waveform(audio, progress, timers=self.timers)

    def _task(self, path: str, fut: Future, cb: RunCallbacks,
              journal_dir: Optional[str]):
        """One file on a worker thread: its decode, then its detection,
        retried once after a transient fault.  A kernel that fails to build
        or launch fails the same way again and becomes the file's error;
        nothing falls back to a plain version."""
        audio = fut.result()
        try:
            return self._detect(path, audio, cb, journal_dir)
        except (IOError, NotImplementedError, ValueError):
            raise  # unreadable or unsupported input: a retry cannot help
        except Exception as e:  # noqa: BLE001 — one retry for a transient fault
            cb.emit("message", f"retrying {path} after: {e!r}")
            return self._detect(path, audio, cb, journal_dir)

    def run(self, files: Iterable[str],
            callbacks: Optional[RunCallbacks] = None) -> RunReport:
        cb = callbacks or RunCallbacks()
        report = RunReport()
        files = list(dict.fromkeys(files))  # a path listed twice runs once
        total = len(files)
        self.meter.reset()
        # per-card throughput counts the mesh a MeshDetector bound
        mesh = getattr(self.detector, "_fused_mesh", None)
        self.meter.n_chips = mesh.size if mesh is not None else 1
        already = self.store.processed_files() if self.cfg.engine.skip_processed_files else set()
        todo = iter([p for p in files if p not in already])
        journal_dir = self.journal_dir()
        k = self.cfg.engine.file_concurrency
        prefetch = ThreadPoolExecutor(max_workers=1)
        workers = ThreadPoolExecutor(max_workers=k)
        decoded: Dict[str, Future] = {}
        in_flight: deque = deque()  # (path, future) in submission order

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
                    self._advance(cb, report, total)
                    continue
                fut = decoded.pop(path)
                prefetch_next()  # the next decode overlaps this detection
                cb.emit("file_started", path)
                in_flight.append((path, workers.submit(self._task, path, fut, cb,
                                                       journal_dir)))
                while len(in_flight) >= k:
                    self._settle(*in_flight.popleft(), cb, report, total)
            while in_flight:  # after a stop() too: the files in flight settle
                self._settle(*in_flight.popleft(), cb, report, total)
        finally:
            # a decode or detection not yet started is dropped; one in
            # progress completes
            prefetch.shutdown(wait=True, cancel_futures=True)
            workers.shutdown(wait=True, cancel_futures=True)
            report.throughput = self.meter.summary()
            report.timers = self.timers.summary()
            cb.emit("finished")
        return report

    def _advance(self, cb: RunCallbacks, report: RunReport, total: int) -> None:
        advanced = report.files_done + report.files_skipped + len(report.errors)
        cb.emit("overall_progress", advanced / max(1, total) * 100.0)

    def _settle(self, path: str, fut: Future, cb: RunCallbacks, report: RunReport,
                total: int) -> None:
        """Persist one detection (this thread only, in submission order)."""
        try:
            result = fut.result()
        except Exception as e:  # noqa: BLE001 — recorded; the run goes on
            report.errors[path] = f"{type(e).__name__}: {e}"
            cb.emit("message", f"detection failed for {path}: {e!r}")
            self._advance(cb, report, total)
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
        self._advance(cb, report, total)
