"""Driver: ``detect`` over a folder of recordings, as the CLI runs one.

The window drives ``runtime.workers.DetectRunner.run`` with an
``engine.Detector`` of the configuration over links to the mix's
recordings, cycled in a seeded order under distinct paths (the runner runs
a path listed twice only once).  It is a closed loop: the next file starts
when the runner takes it.  The window closes at the first file that
completes after ``seconds``; that file counts, and its completion ends the
window.

Set-up writes the recordings (on a thread, beside the model's load),
builds the detector from the configuration's weights file and detects every
distinct recording once, so that every kernel is built and every shape the
window meets has run.

The check (``check``) runs the plain reference (``reference/detect.py``)
once over each distinct recording the window completed, and holds every
completed file to it: the program's averaged grid (recorded from the
result the runner persisted) against the reference's grid, and the
intervals the runner saved in its CSV against the regions that the
reference's region step finds in the program's own grid.
"""

from __future__ import annotations

import csv
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from benchmarks.harness import registry
from benchmarks.reference import detect as ref_detect
from benchmarks.reference import grid as ref_grid


class Driver:
    def __init__(self, cell: registry.Cell, ctx):
        self.cell = cell
        self.ctx = ctx
        self.cfg_program = cell.config["program"]
        self.weights = os.path.join(registry.REPO_DIR, cell.config["weights"])
        self.recordings: List[Dict] = []
        self.link_src: Dict[str, int] = {}     # link path -> recording index
        self.links: List[str] = []
        self._next_link = 0
        self.grids: Dict[str, np.ndarray] = {}  # link path -> program's grid
        self.stores: List[str] = []             # CSV of each timed part
        self.counts = registry.load_module("counts", "specunet2d", cell.root)

    # ------------------------------------------------------------------
    def setup(self, hook=None) -> None:
        traffic = self.cell.traffic
        gen = registry.load_module("generators", traffic["generator"], self.cell.root)
        rec_dir = os.path.join(self.ctx.work, "recordings")
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(gen.generate, traffic["params"], self.ctx.seed, rec_dir)
            from softspoken_tpu_torch import Config
            from softspoken_tpu_torch.engine import Detector

            self.cfg = Config.from_dict(self.cfg_program)
            self.det = Detector(self.cfg, checkpoint_path=self.weights,
                                device=self.ctx.device)
            self.recordings = fut.result()
        self._capture_grids()
        # one list of links for each timed part (a traced run has two), made
        # here so that no window makes its own
        self._make_links(2 * int(self.cell.settings["links"]))
        # every recording once: builds the kernels and runs every shape
        self._run_files([r["path"] for r in self.recordings],
                        os.path.join(self.ctx.work, "warmup.csv"))
        self.grids.clear()
        if hook is not None:
            hook(self)
        self.ctx.sync()

    def _capture_grids(self) -> None:
        """Record each result's averaged grid as the runner receives it."""
        inner = self.det.detect_file_streaming

        def detect_file_streaming(path, *args, **kwargs):
            result = inner(path, *args, **kwargs)
            self.grids[path] = result.avg_values
            return result

        self.det.detect_file_streaming = detect_file_streaming

    def use_control(self, precision: str) -> None:
        """The control: every file answered by the reference chain in
        ``precision`` in the program's place (``control.py``)."""
        from softspoken_tpu_torch.engine.detector import DetectionResult

        ref = ref_detect.Detector(self.weights, self.ctx.device, precision)

        def answer(path, *args, **kwargs):
            grid = ref.detect(path).grid.astype(np.float32)
            return DetectionResult(ref_grid.regions(grid), grid, 0, 0.0)

        self.det.detect_file_streaming = answer
        self._capture_grids()

    def plant_fault(self, name: str, patch=setattr) -> None:
        """Break the timed path underneath (the tests; ``control.py
        --fault``): "state_unchanged", the chunk program returns its carry
        unchanged; "half_batch", half of each chunk's windows left out and
        the grid averaged over the rest; "answer_altered", one interval of
        each result moved where the engine makes it.  ``patch(obj, attr,
        value)`` installs each change."""
        import dataclasses

        from softspoken_tpu_torch.engine import fused

        program, run = fused.FusedStreamingEngine._program, fused.FusedStreamingEngine.run

        def carry_kept(eng, native, lo, fin, starts, place, valid, cs, cc):
            avg, cnt, _cs, _cc = program(eng, native, lo, fin, starts, place, valid, cs, cc)
            return avg, cnt, cs, cc

        def half_left_out(eng, native, lo, fin, starts, place, valid, cs, cc):
            valid = valid.clone()
            valid[valid.shape[0] // 2:] = 0.0
            return program(eng, native, lo, fin, starts, place, valid, cs, cc)

        def altered(eng, *args, **kwargs):
            res = run(eng, *args, **kwargs)
            iv = list(res.intervals)
            iv = [(iv[0][0], iv[0][1] + 0.25)] + iv[1:] if iv else [(0.0, 0.5)]
            return dataclasses.replace(res, intervals=iv)

        attr, fn = {"state_unchanged": ("_program", carry_kept),
                    "half_batch": ("_program", half_left_out),
                    "answer_altered": ("run", altered)}[name]
        patch(fused.FusedStreamingEngine, attr, fn)

    def _make_links(self, count: int) -> None:
        rng = np.random.default_rng([int(self.ctx.seed) & (2**63 - 1), 0x6C696E6B])
        d = os.path.join(self.ctx.work, "folder")
        os.makedirs(d, exist_ok=True)
        n = len(self.recordings)
        order: List[int] = []
        while len(order) < count:
            order.extend(int(i) for i in rng.permutation(n))
        for i in order[:count]:
            path = os.path.join(d, f"rec{len(self.links):06d}.wav")
            try:
                os.symlink(self.recordings[i]["path"], path)
            except OSError:
                os.link(self.recordings[i]["path"], path)
            self.links.append(path)
            self.link_src[path] = i
        fd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(fd)  # the links on disk before the window
        finally:
            os.close(fd)

    def _run_files(self, files: List[str], store_path: str):
        from softspoken_tpu_torch.project.store import DetectionStore
        from softspoken_tpu_torch.runtime.workers import DetectRunner

        runner = DetectRunner(self.det, DetectionStore(store_path), self.cfg)
        report = runner.run(files)
        if report.errors:
            raise RuntimeError(f"set-up detection failed: {report.errors}")

    # ------------------------------------------------------------------
    def window(self, seconds: float, spans: bool = False) -> Dict:
        """One timed part: files until the first completion after
        ``seconds``.  ``spans`` opens a ``record_function`` span around each
        ``DetectRunner.run`` and each file (for a traced slice)."""
        from softspoken_tpu_torch.project.store import DetectionStore
        from softspoken_tpu_torch.runtime.workers import DetectRunner, RunCallbacks

        store_path = os.path.join(self.ctx.work, f"detections{len(self.stores)}.csv")
        self.stores.append(store_path)
        runner = DetectRunner(self.det, DetectionStore(store_path), self.cfg)
        started: Dict[str, float] = {}
        done: List[tuple] = []
        open_spans: Dict[str, object] = {}
        deadline = [0.0]

        def file_started(path: str) -> None:
            started[path] = time.perf_counter()
            if spans:
                open_spans[path] = torch.profiler.record_function("bench.file")
                open_spans[path].__enter__()

        def file_done(path: str) -> None:
            t = time.perf_counter()
            if spans:
                open_spans.pop(path).__exit__(None, None, None)
            src = self.recordings[self.link_src[path]]
            done.append((path, started[path], t, src["seconds"]))
            if t >= deadline[0]:
                runner.stop()

        cb = RunCallbacks(file_started=file_started, file_done=file_done)
        errors: Dict[str, str] = {}
        t0 = time.perf_counter()
        deadline[0] = t0 + seconds
        while True:
            batch = self._take_links(int(self.cell.settings["links"]))
            if spans:
                with torch.profiler.record_function("bench.detect_run"):
                    report = runner.run(batch, cb)
            else:
                report = runner.run(batch, cb)
            errors.update(report.errors)
            if report.stopped or time.perf_counter() >= deadline[0]:
                break
        t1 = time.perf_counter()
        if done:
            ms = np.sort([1e3 * (f[2] - f[1]) for f in done])
            self.ctx.log(f"window: {len(done)} files in {t1 - t0:.3f} s; ms a file min "
                         f"{ms[0]:.1f} median {np.median(ms):.1f} p95 "
                         f"{np.percentile(ms, 95):.3f} max {ms[-1]:.1f}; "
                         f"timers {dict((k, round(v, 3)) for k, v in runner.timers.summary().items())}")
        return {"wall_s": t1 - t0, "files": done, "attempted": len(started), "done": len(done),
                "errors": errors, "timers": runner.timers.summary(),
                "windows": sum(self._windows(p) for p, *_ in done),
                "device_batch": self.cfg.engine.device_batch}

    def _take_links(self, n: int) -> List[str]:
        if self._next_link + n > len(self.links):
            self._make_links(n)
        batch = self.links[self._next_link: self._next_link + n]
        self._next_link += len(batch)
        return batch

    def _windows(self, link: str) -> int:
        r = self.recordings[self.link_src[link]]
        return self.counts.windows(r["frames"], r["sample_rate"])

    def release(self) -> None:
        del self.det
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def check(self, windows: List[Dict]) -> List[Dict]:
        """The compared numbers, each with its limit."""
        limits = self.cell.settings["limits"]
        files = [f for w in windows for f in w["files"]]
        saved = self._saved_intervals()
        ref = ref_detect.Detector(self.weights, self.ctx.device, "float32")
        need = sorted({self.link_src[p] for p, *_ in files})
        refs: Dict[int, ref_detect.Detection] = {}
        with ThreadPoolExecutor(max_workers=4) as ex:
            waves = {i: ex.submit(ref_detect.internal_wave, self.recordings[i]["path"])
                     for i in need}
            for i in need:
                refs[i] = ref.detect_wave(waves[i].result())
        num = den = 0.0
        max_abs = 0.0
        wrong_regions = 0
        for path, *_ in files:
            r = refs[self.link_src[path]]
            grid = np.asarray(self.grids.get(path, np.zeros(0)))
            p = grid.astype(np.float64)
            if p.shape != r.grid.shape:
                max_abs = float("inf")
                wrong_regions += 1
                continue
            num += float(np.sum((p - r.grid) ** 2))
            den += float(np.sum(r.grid ** 2))
            max_abs = max(max_abs, float(np.max(np.abs(p - r.grid))))
            # the regions of the grid as the program holds it (its dtype
            # decides a bin that sits on the threshold)
            got, mine = saved.get(path, []), ref_grid.regions(grid)
            if got != mine:
                wrong_regions += 1
                if wrong_regions <= 3:
                    first = next((k for k, (a, b) in enumerate(zip(got, mine)) if a != b),
                                 min(len(got), len(mine)))
                    self.ctx.log(f"saved regions of {path} differ from its grid's: "
                                 f"{len(got)} saved, {len(mine)} from the grid; first "
                                 f"difference at {first}: {got[first:first + 2]} vs "
                                 f"{mine[first:first + 2]}")
        values = {
            "grid_rel_l2": (num / den) ** 0.5 if den > 0 else float("inf"),
            "grid_max_abs": max_abs,
            "files_wrong_regions": float(wrong_regions),
            "files_checked": float(len(files)),
        }
        return [{"name": k, "value": v, "limit": limits[k]["limit"],
                 "op": limits[k]["op"]} for k, v in values.items()]

    def _saved_intervals(self) -> Dict[str, list]:
        out: Dict[str, list] = {}
        for store in self.stores:
            if not os.path.exists(store):
                continue
            with open(store, newline="", encoding="utf-8") as f:
                for row in csv.DictReader(f):
                    path = os.path.join(row["file_path"], row["file_name"])
                    out.setdefault(path, []).append(
                        (float(row["start_time"]), float(row["end_time"])))
        return out
