"""Headline benchmark: audio-seconds of recording processed per wall-second
per card, end to end (WAV file on disk → merged speech intervals), on one
CUDA card.

    python -m softspoken_tpu_torch bench [--seconds S] [--device cpu]

Baseline: the reference publishes no numbers; the north star is 100× real
time, so ``vs_baseline`` = value / 100.  ``mfu`` is the analytic forward
FLOPs (``runtime.metrics.flops_per_audio_second``) over the card's dense
bf16 peak (``runtime.metrics.device_peak_flops``); on the CPU every ``mfu``
key is null.

Prints exactly one JSON line.  The operating point and the ``BENCH_*``
environment variables are the JAX package's bench's, with the same meanings
and defaults: ``BENCH_SECONDS`` (1800), ``BENCH_REPEATS`` (7),
``BENCH_DEGRADED_RETRIES`` (4), ``BENCH_DEVICE_BATCH`` (128),
``BENCH_CHUNK_SECONDS`` (150), ``BENCH_DEV_BATCH`` (128),
``BENCH_DEV_CHUNK_SECONDS`` (600), ``BENCH_MULTIFILE_K`` (2),
``BENCH_TIME_BUDGET`` (420 s), ``BENCH_HARD_TIMEOUT`` (780 s),
``BENCH_INIT_TIMEOUT`` (600 s), ``BENCH_LINK_WAIT`` (600 s),
``BENCH_LINK_MIN_MBPS`` (8) and ``BENCH_TRACE`` (a directory: the last
repeat runs under ``runtime.profiling.device_trace``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

BASELINE_X_REALTIME = 100.0  # 100× real time


def make_recording(path: str, seconds: float, sr: int = 32000, seed: int = 0) -> None:
    """The JAX bench's synthetic recording: seeded noise with a 2 s 700 Hz
    burst every 30 s, PCM16 mono."""
    from .io import wavio

    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    audio = (0.02 * rng.standard_normal(n)).astype(np.float32)
    # sprinkle speech-band bursts so the pipeline has structure to chew on
    t = np.arange(n) / sr
    for k in range(int(seconds // 30)):
        a = 30.0 * k + 5.0
        m = (t >= a) & (t < a + 2.0)
        audio[m] += 0.3 * np.sin(2 * np.pi * 700.0 * t[m]).astype(np.float32)
    wavio.write(path, audio, sr, subtype="PCM_16")


def device_line(device) -> str:
    """The card's name and power limit as nvidia-smi prints them; "cpu"
    off the card."""
    if device.type != "cuda":
        return device.type
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader", "-i", str(device.index or 0)],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def main(device: Optional[str] = None) -> None:
    import torch

    from .engine.detector import resolve_device

    dev = resolve_device(device)  # no card and no --device cpu: raises

    # Fail fast if the CUDA runtime does not come up: a wedged runtime blocks
    # the first call forever, which would hang the caller with no
    # diagnostic.  Probe it on a watchdog thread and bail out instead.
    ready = threading.Event()

    def _probe() -> None:
        torch.ones(1, device=dev).sum().item()
        ready.set()

    threading.Thread(target=_probe, daemon=True).start()
    deadline = float(os.environ.get("BENCH_INIT_TIMEOUT", "600"))
    if not ready.wait(deadline):
        print(f"bench: {dev} did not initialise within {deadline:.0f}s; "
              "raise BENCH_INIT_TIMEOUT or check the card (nvidia-smi).",
              file=sys.stderr)
        os._exit(3)

    def _sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # Probe the host→device link before timing the link-bound e2e pipeline
    # and wait (bounded) while it reads degraded.  Both probe results and
    # the time spent waiting are recorded in the JSON.
    def _probe_link_mbps(timeout_s: float = 60.0) -> float:
        # on a daemon thread: a stalled copy must not hang the bench
        box: list = []

        def _run() -> None:
            blob = np.zeros(2 * 1024 * 1024, np.int16)  # 4 MB, pageable
            t0 = time.perf_counter()
            torch.tensor(blob, device=dev)
            _sync()
            box.append(blob.nbytes / 1e6 / (time.perf_counter() - t0))

        th = threading.Thread(target=_run, daemon=True)
        th.start()
        th.join(timeout_s)
        return box[0] if box else 0.0

    link_wait = float(os.environ.get("BENCH_LINK_WAIT", "600"))
    link_min = float(os.environ.get("BENCH_LINK_MIN_MBPS", "8"))
    _probe_link_mbps()  # warm the transfer path: the very first copy pays
    #                     one-time setup that would misread a healthy link
    t_wait0 = time.perf_counter()
    link_probe_initial = _probe_link_mbps()
    link_probe = link_probe_initial
    while link_probe < link_min and time.perf_counter() - t_wait0 < link_wait:
        print(f"bench: link degraded ({link_probe:.1f} MB/s < {link_min:.0f}); "
              "waiting for recovery...", file=sys.stderr)
        time.sleep(30.0)
        link_probe = _probe_link_mbps()
    link_waited = time.perf_counter() - t_wait0

    from . import Config
    from .ckpt import fixture_state_dict
    from .engine import Detector
    from .runtime.metrics import (StageTimers, analytic_flops_per_window,
                                  device_peak_flops, mfu)
    from .runtime.profiling import annotate, device_trace

    bench_seconds = float(os.environ.get("BENCH_SECONDS", "1800"))
    cfg = Config().with_engine(
        device_batch=int(os.environ.get("BENCH_DEVICE_BATCH", "128")),
        chunk_seconds=float(os.environ.get("BENCH_CHUNK_SECONDS", "150")),
    )
    det = Detector(cfg, state_dict=fixture_state_dict(seed=0), device=dev)
    peak = device_peak_flops() if dev.type == "cuda" else None

    def _mfu(rate: float) -> Optional[float]:
        return None if peak is None else mfu(rate, peak_flops=peak)

    tmp = os.path.join(tempfile.gettempdir(), "softspoken_bench")
    os.makedirs(tmp, exist_ok=True)
    warm_path = os.path.join(tmp, "warm.wav")
    bench_path = os.path.join(tmp, f"bench_{int(bench_seconds)}s.wav")
    # the JAX bench's 60 s warm file; a shorter benchmark warms on its own
    # length (a smoke run)
    make_recording(warm_path, min(60.0, bench_seconds), seed=1)
    if not os.path.exists(bench_path):
        make_recording(bench_path, bench_seconds)

    # A soft budget (BENCH_TIME_BUDGET: stop adding repeats, skip the
    # multi-file phase) and a hard watchdog (BENCH_HARD_TIMEOUT: print the
    # JSON the completed phases support and exit).  Both clocks start before
    # the warm-up, where the first-call costs land.
    t_bench0 = time.perf_counter()
    soft_budget = float(os.environ.get("BENCH_TIME_BUDGET", "420"))
    hard_timeout = float(os.environ.get("BENCH_HARD_TIMEOUT", "780"))
    payload: dict = {}
    done = threading.Event()

    def _watchdog() -> None:
        if done.wait(hard_timeout):
            return
        if payload.get("value"):
            payload["truncated"] = "hard timeout; later phases skipped"
            print(json.dumps(payload), flush=True)
            os._exit(0)
        print("bench: hard timeout before any timed run completed", file=sys.stderr)
        os._exit(3)

    threading.Thread(target=_watchdog, daemon=True).start()

    def over_budget() -> bool:
        return time.perf_counter() - t_bench0 > soft_budget

    try:
        # warm-up: cuDNN planning and the kernels' first launches are
        # one-time costs; the fused chunk program has one shape whatever the
        # file's length, so the warm file covers the timed run exactly
        det.detect_file_streaming(warm_path)
        det.detect_file_streaming(warm_path)

        # best-of-N headline with median and spread.  Every repeat is
        # bracketed by a 4 MB link probe and stamped with min(pre, post); a
        # repeat with a degraded stamp stays in the raw stats, is left out
        # of ``median_healthy``, and up to BENCH_DEGRADED_RETRIES extra
        # repeats replace it (bounded, budget-respecting).
        repeats = max(1, int(os.environ.get("BENCH_REPEATS", "7")))
        max_extra = int(os.environ.get("BENCH_DEGRADED_RETRIES", "4"))
        trace_dir = os.environ.get("BENCH_TRACE", "")

        def _timed_repeat():
            with annotate("bench.detect_file_streaming"):
                t0 = time.perf_counter()
                res = det.detect_file_streaming(bench_path)
                return res, time.perf_counter() - t0

        repeat_stats: List[dict] = []  # {rate, link_mbps, healthy} per repeat
        extra_used = 0
        traced = False
        link_post = _probe_link_mbps(15.0)
        i = 0
        while i < repeats + extra_used:
            if repeat_stats and over_budget():
                break  # keep what we have; best-of stays honest, just smaller N
            link_pre = link_post
            do_trace = (bool(trace_dir) and not traced
                        and i == repeats + extra_used - 1)
            if do_trace:
                with device_trace(trace_dir, device=dev):
                    result, wall = _timed_repeat()
            else:
                result, wall = _timed_repeat()
            traced = traced or do_trace
            link_post = _probe_link_mbps(15.0)
            stamp = min(link_pre, link_post)
            # classification uses the UNROUNDED stamp; the rounded value is
            # display-only
            healthy_rep = stamp >= link_min
            repeat_stats.append({"rate": round(result.audio_seconds / wall, 2),
                                 "link_mbps": round(stamp, 1),
                                 "healthy": healthy_rep})
            if not healthy_rep and extra_used < max_extra:
                extra_used += 1  # replace the degraded repeat (it stays logged)
            i += 1

        # headline fields first: the watchdog can emit a valid (truncated)
        # JSON line from this point on
        rates = sorted(r["rate"] for r in repeat_stats)
        healthy = [r["rate"] for r in repeat_stats if r["healthy"]]
        value = rates[-1]
        median = _median(rates)
        median_healthy = _median(healthy) if healthy else median
        payload.update({
            "metric": "audio_sec_per_wall_sec_per_chip",
            "value": round(value, 2),
            "unit": "audio-sec/wall-sec/chip (e2e: 32kHz WAV → intervals)",
            "vs_baseline": round(value / BASELINE_X_REALTIME, 3),
            "median": round(median, 2),
            "median_healthy": round(median_healthy, 2),
            "spread": [round(rates[0], 2), round(rates[-1], 2)],
            "repeats": len(repeat_stats),
            "repeats_healthy": len(healthy),
            "repeat_stats": repeat_stats,
            "gflop_per_window": round(analytic_flops_per_window() / 1e9, 3),
            # unrounded: a share of the card's peak, null off the card
            "mfu": _mfu(value),
            "mfu_median": _mfu(median),
            "mfu_median_healthy": _mfu(median_healthy),
            "device": device_line(dev),
        })
        if link_waited > 1.0 or link_probe_initial < link_min:
            payload["link_wait"] = {
                "initial_mbps": round(link_probe_initial, 1),
                "final_mbps": round(link_probe, 1),
                "waited_s": round(link_waited, 1),
            }

        # device-only: the chunk program with every input resident, which
        # separates the card's compute from the host→device link.  Measured
        # at the device-optimal operating point (B=128, 600 s chunks: longer
        # chunks amortize the per-dispatch cost; 150 s chunks win end to end
        # only because they overlap upload with compute, which this number
        # excludes).
        from .engine.fused import _i16_kind, get_fused_engine
        from .io import wavio

        sr_native = wavio.info(bench_path).samplerate
        dev_cfg = Config().with_engine(
            device_batch=int(os.environ.get("BENCH_DEV_BATCH", "128")),
            chunk_seconds=float(os.environ.get("BENCH_DEV_CHUNK_SECONDS", "600")),
        )
        if dev_cfg.engine == cfg.engine:
            dev_det = det
        else:
            dev_det = Detector(dev_cfg, state_dict=fixture_state_dict(seed=0), device=dev)
        wire_kind = _i16_kind(det)  # "i16" unless a lossy upload_codec is set
        # wire decimation (io/decimate.py) ships the stream at sr/M on a
        # lossy wire; the device program then resamples from that rate, so
        # both the device-only engine and the link math use it
        wire_sr = sr_native
        if wire_kind in ("mulaw8", "adpcm4") and cfg.engine.wire_decimate == "auto":
            from .io.decimate import decim_factor

            wire_sr = sr_native // decim_factor(sr_native, cfg.dsp.f_max)
        dev_eng = get_fused_engine(dev_det, wire_sr, wire_kind)
        device_only = max(dev_eng.device_only_rate(), dev_eng.device_only_rate())
        payload.update({
            "device_only": round(device_only, 2),
            "device_only_mfu": _mfu(device_only),
            "wire_codec": wire_kind,
            "wire_sr": wire_sr,
        })

        # the e2e number's link ceiling: achieved pageable host→device bytes/s
        # over the wire's bytes per audio-second (32 kHz int16 mono is
        # 64 KB/s), measured with the copy the engine makes
        up_bytes = 32 * 1024 * 1024
        blob = np.zeros(up_bytes // 2, np.int16)
        up_rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            torch.tensor(blob, device=dev)
            _sync()
            up_rates.append(up_bytes / (time.perf_counter() - t0))
        upload_bps = max(up_rates)
        # mu-law ships 1 B/sample, the 4-bit ADPCM wire ~0.516 B/sample
        # (ops/adpcm.py incl. headers), int16 2 B/sample
        wire_bps = {"mulaw8": 1.0, "adpcm4": 132.0 / 256.0}.get(wire_kind, 2.0)
        link_bound_rate = upload_bps / (wire_sr * wire_bps)
        payload.update({
            "upload_mbps": round(upload_bps / 1e6, 1),
            "link_bound_rate": round(link_bound_rate, 1),
            "link_utilization": round(value / link_bound_rate, 3),
        })

        # multi-file aggregate: K files in flight on threads sharing the
        # detector (runtime/workers.py file_concurrency), each with its own
        # stage timers, so the breakdown shows where the files overlap.
        # Optional phase: skipped when the soft budget is spent.
        if not over_budget():
            k_files = max(2, int(os.environ.get("BENCH_MULTIFILE_K", "2")))
            paths = [bench_path]
            for j in range(1, k_files):
                p = os.path.join(tmp, f"bench_{int(bench_seconds)}s_{j}.wav")
                if not os.path.exists(p):
                    make_recording(p, bench_seconds, seed=7 + j)
                paths.append(p)
            det.detect_file_streaming(paths[1])  # warm the extra files' shapes
            multi = []
            for _ in range(2):
                if multi and over_budget():
                    break
                pre = _probe_link_mbps(15.0)
                t0 = time.perf_counter()
                tms = [StageTimers() for _ in paths]
                with ThreadPoolExecutor(len(paths)) as ex:
                    futs = [ex.submit(det.detect_file_streaming, p, timers=tm)
                            for p, tm in zip(paths, tms)]
                    for f in futs:
                        f.result()
                wall = time.perf_counter() - t0
                stage_totals: dict = {}
                for tm in tms:
                    for k, v in tm.summary().items():
                        stage_totals[k] = round(stage_totals.get(k, 0.0) + v, 3)
                multi.append({"rate": round(k_files * bench_seconds / wall, 2),
                              "link_mbps": round(min(pre, _probe_link_mbps(15.0)), 1),
                              "wall_s": round(wall, 3),
                              "stage_totals_s": stage_totals})
            payload["multifile_rate"] = round(max(m["rate"] for m in multi), 2)
            payload["multifile_k"] = k_files
            payload["multifile_stats"] = multi
    finally:
        done.set()

    print(json.dumps(payload), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
