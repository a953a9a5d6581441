"""Device profiling hooks.

The reference's only perf instrumentation is wall-clock prints
(review_detections.py:97,171-172) and the live audio-sec/wall-sec label
(silencer_ui.py:152-158).  Here: the same counters live in
``runtime.metrics``, and this module adds ``torch.profiler`` capture, with
the card's kernels when the device is a CUDA card, written as a Chrome
trace (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Iterator, Optional

from .metrics import Span, current_key


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None, device=None) -> Iterator[str]:
    """Capture a ``torch.profiler`` trace around a block into ``log_dir``.

    with device_trace() as d: run_hot_path()

    CPU activity always; CUDA activity too when ``device`` is a card (the
    default: when CUDA is available).  Every thread is recorded (the
    runner's worker, the fused engine's fill and upload threads), on one
    clock with the kernels, and each span's input (its file's index) is
    kept.  The block's trace is written on exit as
    ``<log_dir>/trace_<pid>.json`` (Chrome trace format); ``log_dir``
    defaults to ``$SOFTSPOKEN_TRACE_DIR``, else ``softspoken_trace`` under
    the temporary directory (``$TMPDIR``).
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = (log_dir or os.environ.get("SOFTSPOKEN_TRACE_DIR")
               or os.path.join(tempfile.gettempdir(), "softspoken_trace"))
    os.makedirs(log_dir, exist_ok=True)
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=activities, record_shapes=True,
                 experimental_config=every_thread) as prof:
        yield log_dir
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


def annotate(name: str) -> Span:
    """Context manager marking a host-side stage in the profiler trace: the
    recorder's span (``runtime.metrics.Span``) without a recorder, under
    the calling thread's key.  Nothing is made while no profiler is active.
    """
    return Span(None, name, current_key())
