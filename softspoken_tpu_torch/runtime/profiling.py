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
import functools
import os
from typing import Iterator, Optional


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None, device=None) -> Iterator[str]:
    """Capture a ``torch.profiler`` trace around a block into ``log_dir``.

    with device_trace("/tmp/trace") as d: run_hot_path()

    CPU activity always; CUDA activity too when ``device`` is a card (the
    default: when CUDA is available).  The block's trace is written on exit
    as ``<log_dir>/trace_<pid>.json`` (Chrome trace format).
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.environ.get("SOFTSPOKEN_TRACE_DIR", "/tmp/softspoken_trace")
    os.makedirs(log_dir, exist_ok=True)
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield log_dir
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Context manager marking a host-side stage in the profiler trace: a
    ``record_function`` span, and an NVTX range when CUDA is initialised.

    Context-manager only, as in the JAX package; decorate functions with
    :func:`annotate_function`.
    """
    import torch

    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def annotate_function(fn, name: Optional[str] = None):
    """Decorator form: wraps ``fn`` in :func:`annotate` (default name: the
    function's qualified name)."""
    label = name or fn.__qualname__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with annotate(label):
            return fn(*args, **kwargs)

    return wrapper
