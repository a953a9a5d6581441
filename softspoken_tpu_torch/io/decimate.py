"""Integer-factor host decimation for the fused upload wire.

A copy of the JAX package's ``io/decimate.py``.  The model sees nothing
above ``dsp.f_max`` (8 kHz): the mel filterbank's top edge is ``f_max`` and
the device resample to 22050 Hz lowpasses at 11.025 kHz.  So when a
recording's native rate is an integer multiple ``M`` of a rate >= 2*f_max,
the lossy wires (mulaw8, adpcm4) carry the stream decimated by ``M``
(32 kHz -> 16 kHz), losing only a narrow transition band around f_max.

Design: one zero-phase Kaiser lowpass per (sr, M), its stopband where
frequencies start to fold into [0, f_max] (never narrower than f_max+400
Hz), 60 dB down.  The hot loop is ``csrc/ssdsp.cpp::ss_fir_decim_i16``
(through ``io/native.py``), with a tiled numpy fallback; the two agree to
about 1 LSB.  ``WireDecimator.read`` is a pure function of (start, frames):
an output sample is bit-identical however the requests are windowed, which
the fused engine's overlapping chunk reads rely on.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable

import numpy as np
import scipy.signal

from . import native

STOP_ATTEN_DB = 60.0
# Bumped whenever the produced WIRE SAMPLES can change for the same input
# (a chunk journal may stitch grids only across identical computations).
# v2: sinc-null taps snapped to exact 0.0 (changes products ~1e-13 f32,
# can flip an int16 LSB at a rounding boundary).  Kept equal to the JAX
# package's.
DECIM_VERSION = 2
# minimum transition half-width around f_max in the tight (sr/M == 2*f_max)
# case; wider transitions are used automatically whenever the rates allow
_TIGHT_HZ = 400.0


def decim_factor(native_sr: int, f_max: float = 8000.0) -> int:
    """Largest integer M with ``native_sr % M == 0`` and
    ``native_sr/M >= 2*f_max`` (so the decimated Nyquist still covers the
    mel band).  1 means "don't decimate"."""
    best = 1
    floor_rate = 2.0 * float(f_max)
    m = 2
    while native_sr / m >= floor_rate:
        if native_sr % m == 0:
            best = m
        m += 1
    return best


@lru_cache(maxsize=32)
def decim_taps(native_sr: int, factor: int, f_max: float = 8000.0) -> np.ndarray:
    """Odd-length linear-phase lowpass for decimation by ``factor``.

    float32, unit DC gain; symmetric, so correlation == convolution and the
    centered application in :class:`WireDecimator` is exactly zero-phase.
    """
    if factor < 2:
        raise ValueError("decimation factor must be >= 2")
    out_rate = native_sr / factor
    nyq = native_sr / 2.0
    fold = out_rate - float(f_max)  # lowest input freq aliasing into the band
    stop = max(fold, float(f_max) + _TIGHT_HZ)
    pass_ = min(float(f_max), stop - 2.0 * _TIGHT_HZ)
    numtaps, beta = scipy.signal.kaiserord(STOP_ATTEN_DB, (stop - pass_) / nyq)
    numtaps = int(numtaps) | 1  # odd -> integer group delay
    h = scipy.signal.firwin(
        numtaps, (pass_ + stop) / 2.0 / nyq, window=("kaiser", beta))
    # Snap the sinc nulls to EXACT zeros (they compute as ~1e-17 residue):
    # the M=2 cutoff is always sr/4, i.e. a half-band filter whose odd
    # offsets from center all vanish — one polyphase branch collapses to the
    # single center tap.  With exact 0.0 taps, `acc += 0.0f*x` is a bit-exact
    # no-op for finite x, so the native kernel's nonzero-range trim
    # (csrc/ssdsp.cpp::ss_fir_decim_i16) halves the FIR work without
    # changing a single output bit; the response change from the snap itself
    # is ~1e-16, far below the f32 cast.
    h[np.abs(h) < 1e-12 * np.abs(h).max()] = 0.0
    return h.astype(np.float32)


class WireDecimator:
    """Pure random-access decimated view over a native int16 reader.

    ``read_native(start, frames) -> int16`` supplies native samples (may
    return short at EOF); ``read(start, frames)`` returns the decimated
    stream sample ``j`` as the zero-phase FIR output centered on native
    sample ``j*factor``, treating samples outside ``[0, native_frames)`` as
    zero (the same zero-extension the fused engine's own +-3 s padding
    applies; the only divergence from "decimate the padded stream" is
    filter ringing within ~T/2 samples of the pad joins, the class of edge
    effect already documented for the fused path in engine/fused.py).
    """

    def __init__(self, read_native: Callable[[int, int], np.ndarray],
                 native_frames: int, native_sr: int, factor: int,
                 f_max: float = 8000.0):
        if native_sr % factor != 0:
            raise ValueError(f"{factor} does not divide {native_sr}")
        self.h = decim_taps(native_sr, factor, f_max)
        self.h64 = self.h.astype(np.float64)
        self.T = len(self.h)
        self.half = self.T // 2
        self.M = int(factor)
        self.read_native = read_native
        self.native_frames = int(native_frames)
        self.frames = int(native_frames) // self.M
        self.sr = native_sr // self.M

    def read(self, start: int, frames: int) -> np.ndarray:
        frames = min(frames, self.frames - start)
        if frames <= 0:
            return np.zeros(0, np.int16)
        a0 = start * self.M - self.half
        L = (frames - 1) * self.M + self.T
        b0, b1 = max(a0, 0), min(a0 + L, self.native_frames)
        if b0 == a0 and b1 == a0 + L:
            # interior read: hand the reader's buffer straight to the kernel
            # — the zero+copy staging below costs a fresh ~10 MB allocation
            # plus a memcpy per chunk on the 1-core host, and only the first/
            # last chunk of a file ever overlaps the zero-extension
            got = np.asarray(self.read_native(b0, L))
            if len(got) == L:
                y = native.fir_decim_i16(got, self.h, self.M, frames)
                if y is None:
                    y = self._decimate_numpy(got, frames)
                return y
        xbuf = np.zeros(L, np.int16)
        if b1 > b0:
            got = np.asarray(self.read_native(b0, b1 - b0))
            xbuf[b0 - a0: b0 - a0 + len(got)] = got
        y = native.fir_decim_i16(xbuf, self.h, self.M, frames)
        if y is None:
            y = self._decimate_numpy(xbuf, frames)
        return y

    def _decimate_numpy(self, xbuf: np.ndarray, n_out: int) -> np.ndarray:
        """Tiled fallback (float64 dot): same contract, ~1 LSB of the
        native kernel (different accumulation precision/order)."""
        y = np.empty(n_out, np.int16)
        tile = 65536
        win = np.lib.stride_tricks.sliding_window_view(xbuf, self.T)[:: self.M]
        for j0 in range(0, n_out, tile):
            j1 = min(j0 + tile, n_out)
            acc = win[j0:j1].astype(np.float64) @ self.h64
            y[j0:j1] = np.clip(np.rint(acc), -32768, 32767).astype(np.int16)
        return y
