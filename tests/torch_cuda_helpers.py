"""What the port's card tests (tests/test_torch_*cuda.py) share: the skips,
the seeded field recording they detect on, and one counted detect.

It imports torch and the port only, never JAX, as the card tests do.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def need_cards(n: int = 2):
    need_card()
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards, {torch.cuda.device_count()} visible")


def field_signal(seconds: float, sr: int, seed: int) -> np.ndarray:
    """Seeded noise floor with speech-band bursts (modulated 300-3000 Hz
    tones, 2.5 s every 20 s from 5 s on), float32 mono."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    x = (0.01 * rng.standard_normal(n)).astype(np.float32)
    t = np.arange(int(2.5 * sr)) / sr
    env = (0.5 + 0.5 * np.sin(2 * np.pi * 4 * t)).astype(np.float32)
    for k, s0 in enumerate(range(5 * sr, n - len(t), 20 * sr)):
        f = 300 + (k * 371) % 2700
        x[s0: s0 + len(t)] += (0.3 * env * np.sin(2 * np.pi * f * t)).astype(np.float32)
    return x


def field_wav(path: str, seconds: float, sr: int, seed: int) -> str:
    """``field_signal`` written as a PCM16 mono WAV; returns ``path``."""
    from softspoken_tpu_torch.io import wavio

    wavio.write(path, field_signal(seconds, sr, seed), sr, subtype="PCM_16")
    return path


def counted_detect(det, path: str, **kw) -> tuple:
    """(result, counters, kernel launches, native calls) of one
    ``detect_file_streaming`` on the card, every count set to 0 just before."""
    from softspoken_tpu_torch.io import native
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES, reset_launch_counts
    from softspoken_tpu_torch.runtime.metrics import StageTimers

    timers = StageTimers()
    reset_launch_counts()
    native.reset_call_counts()
    res = det.detect_file_streaming(path, timers=timers, **kw)
    torch.cuda.synchronize()
    return res, timers.counted(), KERNEL_LAUNCHES.copy(), dict(native.NATIVE_CALLS)
