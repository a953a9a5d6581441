"""Native host DSP (``csrc/ssdsp.cpp`` through ctypes).

Counterpart of the JAX package's ``io/native.py``: the multithreaded C++
polyphase resampler, channel downmix and PCM16 → mono float32 decode, and
the upload wires' host loops (the decimation FIR, the mu-law table gather
and the IMA-ADPCM block encoder), compiled with g++ on first use
(``ops/_build.build_host``, into ``ops/_build.BUILD_DIR``: the checkout's
``build/softspoken_tpu_torch/``, or a user cache when the package is
installed).  These are host code, not
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
            lib.ss_fir_decim_i16.argtypes = [
                i16p, ctypes.c_int64, i16p, ctypes.c_int64, f32p, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32]
            lib.ss_fir_decim_i16.restype = None
            lib.ss_mulaw_encode_i16.argtypes = [
                i16p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int8),
                ctypes.POINTER(ctypes.c_int8), ctypes.c_int32]
            lib.ss_mulaw_encode_i16.restype = None
            lib.ss_ima_encode_i16.argtypes = [
                i16p, ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8)]
            lib.ss_ima_encode_i16.restype = None
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


def _i16p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def mulaw_encode_i16(x: np.ndarray, lut: np.ndarray,
                     out: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    """int16 PCM → int8 mu-law codes through the 64 Ki table; None if native
    code is absent.  ``out`` (contiguous int8, ``len(x)``) avoids the output
    allocation."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.int16)
    lut = np.ascontiguousarray(lut, np.int8)
    if out is None:
        q = np.empty(len(x), np.int8)
    else:
        # not `assert`: the native loop writes through this pointer
        if out.dtype != np.int8 or not out.flags.c_contiguous:
            raise ValueError("out must be a contiguous int8 buffer")
        if len(out) != len(x):
            raise ValueError(f"out length {len(out)} != input length {len(x)}")
        q = out
    lib.ss_mulaw_encode_i16(
        _i16p(x), len(x), lut.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), _threads())
    NATIVE_CALLS["mulaw_encode_i16"] += 1
    return q


def fir_decim_i16(xbuf: np.ndarray, h: np.ndarray, M: int,
                  n_out: int) -> Optional[np.ndarray]:
    """Zero-phase FIR decimation by ``M`` (``io/decimate.py``'s contract):
    ``y[j] = clip(rint(sum_k h[k] * xbuf[j*M + k]))``; None if native code
    is absent.  ``len(xbuf)`` must be ``(n_out-1)*M + len(h)``."""
    lib = get_lib()
    if lib is None:
        return None
    xbuf = np.ascontiguousarray(xbuf, np.int16)
    h = np.ascontiguousarray(h, np.float32)
    # not `assert`: the loop reads xbuf[(n_out-1)*M + T - 1]
    if len(xbuf) != (n_out - 1) * M + len(h):
        raise ValueError(
            f"xbuf length {len(xbuf)} != (n_out-1)*M+T = {(n_out - 1) * M + len(h)}")
    y = np.empty(n_out, np.int16)
    # one thread: the threaded path of ss_fir_decim_i16 (n_out >= 65536)
    # hands its workers the name of a `static thread_local` scratch vector,
    # so each worker reads its own empty vector and the process crashes.
    # The JAX package passes its thread count and crashes on any multi-core
    # host; each output's sum has a fixed order, so one thread gives the
    # same bits.
    lib.ss_fir_decim_i16(_i16p(xbuf), len(xbuf), _i16p(y), n_out, _f32p(h), len(h), M, 1)
    NATIVE_CALLS["fir_decim_i16"] += 1
    return y


def ima_encode_i16(x: np.ndarray, out: np.ndarray, spb: int) -> Optional[np.ndarray]:
    """int16 PCM → 4-bit IMA-ADPCM wire blocks into ``out``; None if native
    code is absent.  ``out`` must be contiguous uint8 of exactly
    ``ceil(len(x)/spb) * (4 + spb//2)`` bytes (``ops/adpcm.wire_bytes``)."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.int16)
    want = -(-len(x) // spb) * (4 + spb // 2)
    # not `assert`: the loop writes through the raw pointer
    if out.dtype != np.uint8 or not out.flags.c_contiguous or len(out) != want:
        raise ValueError(f"out must be contiguous uint8[{want}]")
    lib.ss_ima_encode_i16(_i16p(x), len(x), spb,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    NATIVE_CALLS["ima_encode_i16"] += 1
    return out
