"""Throughput and stage timing.

The reference's headline number is the Voice Detector screen's "Processing
Speed (audio sec / real sec)" (``silencer_ui.py:152-158, 276-299``); here it
is a counter decoupled from any GUI, beside the port's one recorder of spans
and counters (``StageTimers``), whose spans also reach an active
``torch.profiler`` on every thread.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _profiler


@dataclass
class ThroughputMeter:
    """Audio-seconds processed per wall-second."""

    n_chips: int = 1
    audio_seconds: float = 0.0
    _t0: float = field(default_factory=time.perf_counter)

    def reset(self) -> None:
        self.audio_seconds = 0.0
        self._t0 = time.perf_counter()

    def add_audio(self, seconds: float) -> None:
        self.audio_seconds += seconds

    @property
    def wall_seconds(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def audio_sec_per_wall_sec(self) -> float:
        w = self.wall_seconds
        return self.audio_seconds / w if w > 0 else 0.0

    @property
    def per_chip(self) -> float:
        return self.audio_sec_per_wall_sec / max(1, self.n_chips)

    def summary(self) -> Dict[str, float]:
        wall = self.wall_seconds  # one clock reading for a consistent record
        rate = self.audio_seconds / wall if wall > 0 else 0.0
        return {
            "audio_seconds": self.audio_seconds,
            "wall_seconds": wall,
            "audio_sec_per_wall_sec": rate,
            "audio_sec_per_wall_sec_per_chip": rate / max(1, self.n_chips),
        }


class Span:
    """One span of work: its wall time goes to ``recorder`` (a StageTimers,
    or None), and while a ``torch.profiler`` is active it is also a
    ``record_function`` on the calling thread, on the profiler's clock, with
    ``key`` (the file's index; None: no argument) as its argument.  With no
    profiler active the cost beyond the clock is one flag read."""

    __slots__ = ("_recorder", "_name", "_key", "_t0", "_handle")

    def __init__(self, recorder: Optional["StageTimers"], name: str,
                 key: Optional[int] = None):
        self._recorder, self._name, self._key = recorder, name, key

    def __enter__(self) -> "Span":
        self._handle = None
        if _profiler._is_profiler_enabled:
            args = () if self._key is None else (self._key,)
            self._handle = torch.autograd._record_function_with_args_enter(self._name, *args)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self._t0
        if self._recorder is not None:
            self._recorder.add(self._name, dt)
        if self._handle is not None:
            torch.autograd._record_function_with_args_exit(self._handle)
        return False


# this thread's recorder and key: deep code without a ``timers`` parameter
# (the chunk program, the grid update, the forward per batch) records here
_current = threading.local()


def current_key() -> Optional[int]:
    """The key (file index) of the calling thread's current recorder."""
    return getattr(_current, "key", None)


@contextmanager
def recording(recorder: Optional["StageTimers"], key: Optional[int] = None):
    """Make ``recorder`` and ``key`` the calling thread's current ones for
    the block (``recorder`` None: spans reach only an active profiler)."""
    prev = (getattr(_current, "recorder", None), current_key())
    _current.recorder, _current.key = recorder, key
    try:
        yield
    finally:
        _current.recorder, _current.key = prev


def span(name: str) -> Span:
    """A span into the calling thread's current recorder, under its key."""
    return Span(getattr(_current, "recorder", None), name, current_key())


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to a counter of the calling thread's current recorder."""
    recorder = getattr(_current, "recorder", None)
    if recorder is not None:
        recorder.count(name, n)


class StageTimers:
    """The port's recorder of spans and counters; safe to use from several
    threads (the fused engine's fill and upload threads add to it).

    ``time(name)`` is a span (``Span``): its seconds add to ``totals[name]``
    and one to ``calls[name]``.  ``count(name, n)`` adds to ``counters``.
    ``summary()`` is one flat dict: each span's seconds under its name and
    each counter under ``count.<name>``.  The detect path counts
    ``chunks``, ``batches``, ``windows_live`` and ``windows_launched``
    (``engine/fused.py``) and ``batches_nhwc``, the U-Net batches that ran
    the channels-last fused path (``models/unet.py``): on the card in fast
    mode every batch, elsewhere none."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] += seconds
            self.calls[name] += 1

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def time(self, name: str) -> Span:
        """A span of this recorder under the calling thread's key."""
        return Span(self, name, current_key())

    def seconds(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.totals)

    def counted(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counters)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self.totals)
            out.update((f"count.{k}", float(v)) for k, v in self.counters.items())
            return out

    def report(self) -> str:
        return json.dumps({k: round(v, 4) for k, v in sorted(self.summary().items())})


# ---------------------------------------------------------------------------
# FLOPs accounting / MFU
# ---------------------------------------------------------------------------

# Dense bf16 tensor-core peak by ``torch.cuda.get_device_name()``: the U-Net's
# fast-mode convs and K1's wgmma products run bf16.  NVIDIA H100 Tensor Core
# GPU datasheet (H100 SXM5: 1,979 TFLOP/s bf16 with sparsity, half of it
# dense).  A card not listed here has no default peak.
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


def device_peak_flops() -> float:
    """The dense bf16 peak of the current CUDA card.

    Raises ``RuntimeError`` with no card and ``KeyError`` for a card the
    table does not list: an MFU against a guessed peak is no measurement."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: mfu needs an explicit peak_flops")
    device_name = torch.cuda.get_device_name()
    if device_name not in PEAK_BF16_FLOPS:
        raise KeyError(f"no bf16 peak known for {device_name!r}; pass peak_flops")
    return PEAK_BF16_FLOPS[device_name]


def analytic_flops_per_window(include_spec_head: bool = False) -> float:
    """Analytic forward FLOPs for ONE 3 s window (mel frontend + U-Net).

    The JAX package's count, term for term (SURVEY.md §2.1,
    pytorch_neural_nets.py:79-197): multiply-accumulate = 2 FLOPs;
    BN/ReLU/pool elementwise terms are <1% and ignored.  The mel frontend is
    counted as the full 512×2050 DFT product although K1 computes only the
    768 live bins: the count measures the model's work, not one
    implementation's.  Detection fetches only the mask head, so the spec
    head is excluded by default.
    """

    def resblock2d(h, w, cin, cout):
        proj = 2 * h * w * cin * cout           # 1×1 shortcut
        c1 = 2 * h * w * 9 * cin * cout         # 3×3
        c2 = 2 * h * w * 9 * cout * cout        # 3×3
        return proj + c1 + c2

    f = 0.0
    # mel frontend: frames(256×512) @ DFT(512×2050) + power +
    # (256×1025) @ mel(1025×128)
    f += 2 * 256 * 512 * 2050
    f += 3 * 256 * 1025
    f += 2 * 256 * 1025 * 128

    # encoder
    f += resblock2d(128, 256, 1, 32)
    f += resblock2d(64, 128, 32, 64)
    f += resblock2d(32, 64, 64, 96)
    f += resblock2d(16, 32, 96, 128)
    # bottleneck ×2
    f += 2 * resblock2d(8, 16, 128, 128)
    # decoder (upsample + skip concat)
    f += resblock2d(16, 32, 256, 96)
    f += resblock2d(32, 64, 192, 64)
    f += resblock2d(64, 128, 128, 32)
    f += resblock2d(128, 256, 64, 32)
    # mask head: Conv2d(32→4, kernel 128×1) + ResBlock1D(4,4) + Conv1d(4→1)
    f += 2 * 256 * (128 * 32) * 4
    f += 2 * 256 * (4 * 4 + 3 * 4 * 4 + 3 * 4 * 4)
    f += 2 * 256 * 4
    if include_spec_head:
        f += resblock2d(128, 256, 32, 32)
        f += 2 * 128 * 256 * 32 * 2
    return float(f)


def flops_per_audio_second(step_seconds: float = 0.6,
                           include_spec_head: bool = False) -> float:
    """FLOPs the pipeline must execute per second of audio (one window per
    ``step_seconds`` of recording)."""
    return analytic_flops_per_window(include_spec_head) / step_seconds


def mfu(audio_sec_per_wall_sec: float,
        peak_flops: Optional[float] = None,
        step_seconds: float = 0.6) -> float:
    """Model FLOPs Utilization: achieved forward FLOPs/s over the peak.

    ``peak_flops=None`` takes the current card's dense bf16 peak
    (``device_peak_flops``), and raises without a card or for a card the
    table does not list."""
    if peak_flops is None:
        peak_flops = device_peak_flops()
    return audio_sec_per_wall_sec * flops_per_audio_second(step_seconds) / peak_flops
