"""Native host DSP (``csrc/ssdsp.cpp`` through ctypes).

Counterpart of the JAX package's ``io/native.py``: the multithreaded C++
polyphase resampler, channel downmix and PCM16 → mono float32 decode,
compiled with g++ on first use (``ops/_build.build_host``, into the
checkout's ``build/softspoken_tpu_torch/``).  These are host code, not
device kernels.  Without a compiler, or with ``SOFTSPOKEN_DISABLE_NATIVE``
set, every wrapper returns None and the callers take their numpy/scipy
path: the native code is a speed tier, not a dependency.

``NATIVE_CALLS`` counts, per entry point, the calls that ran native code
(the FLAC decoder in ``io/flac.py`` counts its reads here too), so a run
can show that it went through the native path.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from collections import Counter
from typing import Optional

import numpy as np

from ..ops import _build

log = logging.getLogger(__name__)

NATIVE_CALLS: Counter = Counter()

_lib: Optional[ctypes.CDLL] = None
_tried = False
_load_lock = threading.Lock()


def reset_call_counts() -> None:
    NATIVE_CALLS.clear()


def load_host_lib(name: str) -> Optional[ctypes.CDLL]:
    """``csrc/<name>.cpp`` built and loaded, or None when native code is
    disabled or cannot be built here."""
    if os.environ.get("SOFTSPOKEN_DISABLE_NATIVE"):
        return None
    try:
        return ctypes.CDLL(_build.build_host(name))
    except (RuntimeError, OSError, FileNotFoundError) as e:
        log.info("native build of %s unavailable (%s)", name, e)
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    with _load_lock:
        # _tried is published only after the build, so a concurrent caller
        # neither sees a half-initialised library nor starts a second g++
        if _tried:
            return _lib
        lib = load_host_lib("ssdsp")
        if lib is not None:
            f32p, i16p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int16)
            lib.ss_resample_f32.argtypes = [
                f32p, ctypes.c_int64, f32p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ]
            lib.ss_resample_f32.restype = None
            lib.ss_downmix_f32.argtypes = [
                f32p, ctypes.c_int64, ctypes.c_int32, f32p, ctypes.c_int32]
            lib.ss_downmix_f32.restype = None
            lib.ss_pcm16_to_mono_f32.argtypes = [
                i16p, ctypes.c_int64, ctypes.c_int32, f32p, ctypes.c_int32]
            lib.ss_pcm16_to_mono_f32.restype = None
        _lib = lib
        _tried = True
        return lib


def _threads() -> int:
    return max(1, min(8, (os.cpu_count() or 2) - 1))


def native_available() -> bool:
    return get_lib() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resample_f32(x: np.ndarray, up: int, down: int,
                 taps: np.ndarray) -> Optional[np.ndarray]:
    """``scipy.signal.resample_poly``-equivalent conversion of 1-D float32
    audio with ``taps``; None if native code is absent."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim != 1:
        raise ValueError(f"resample_f32 takes 1-D input, got shape {x.shape}")
    taps = np.ascontiguousarray(taps, np.float64)
    n_out = -(-(len(x) * up) // down)
    y = np.empty(n_out, np.float32)
    lib.ss_resample_f32(
        _f32p(x), len(x), _f32p(y), n_out,
        taps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(taps),
        up, down, _threads(),
    )
    NATIVE_CALLS["resample_f32"] += 1
    return y


def downmix_f32(x: np.ndarray) -> Optional[np.ndarray]:
    """(frames, channels) float32 → mono channel mean; None if native code
    is absent."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim != 2:
        raise ValueError(f"downmix_f32 takes (frames, channels), got shape {x.shape}")
    frames, channels = x.shape
    y = np.empty(frames, np.float32)
    lib.ss_downmix_f32(_f32p(x), frames, channels, _f32p(y), _threads())
    NATIVE_CALLS["downmix_f32"] += 1
    return y


def pcm16_to_mono_f32(raw: np.ndarray, channels: int) -> Optional[np.ndarray]:
    """Interleaved int16 → mono float32 (decode and downmix in one pass);
    None if native code is absent."""
    lib = get_lib()
    if lib is None:
        return None
    if channels <= 0:
        raise ValueError(f"channels must be positive, got {channels}")
    raw = np.ascontiguousarray(raw, np.int16)
    frames = len(raw) // channels
    y = np.empty(frames, np.float32)
    lib.ss_pcm16_to_mono_f32(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), frames, channels,
        _f32p(y), _threads())
    NATIVE_CALLS["pcm16_to_mono_f32"] += 1
    return y
