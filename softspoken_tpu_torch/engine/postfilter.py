"""Opt-in music post-filter: drop detected regions whose surrounding audio
has a strong rhythmic (beat) signature.

A copy of the JAX package's ``engine/postfilter.py`` (numpy on the host, as
there).  Music is the trained checkpoint's one measured real false-positive
class (docs/QUALITY_r03_realaudio.json): a house-music loop is flagged
about half of its duration at the parity operating point.  This module
attacks that failure at inference time with a classic speech/music
discriminator (Scheirer & Slaney 1997 family) built from the low-band
onset envelope:

  * **onset envelope** — half-wave-rectified spectral flux of the log
    magnitude STFT, summed over bins below 1.5 kHz only.  Music's beat
    lives in kick/bass onsets; restricting to the low band removes the
    broadband periodic textures (hum, synthetic noise beds) that fool a
    full-band envelope.
  * **beat** — peak of the envelope's normalized autocorrelation over
    beat-range lags (0.23–1.2 s, 50–260 BPM).  Rhythmic onsets repeat at
    a stable period; speech syllables do not.
  * **beat2** — the autocorrelation at twice the best beat lag (a real
    beat has harmonics; a chance peak does not).
  * **sharp** — the beat peak minus the median autocorrelation in the
    ±25% lag neighborhood (excluding ±5% around the peak): a true tempo
    is a sharp spike, a drifting pseudo-period is a broad bump.
  * **stab** — tempo stability: beat strength confirmed independently in
    both halves of the context at (nearly) the same lag; 0 otherwise.

``music_score`` = beat + 0.5·max(beat2,0) + 0.5·max(sharp,0) + 0.5·stab.
The default threshold 0.85 and its evidence are the JAX package's
(docs/MUSIC_FILTER_GATE_r04.json): above the worst-scoring true-speech
context of the synthetic grid, below the pure-music medians.

Application rule (``filter_intervals``): each detected region is scored
over a context window (the region extended symmetrically to >= 4 s,
clamped to the file) and dropped when the score >= threshold.  Regions
whose context could not be read (decode error, < 2.5 s of audio) are
always KEPT — the filter can only ever drop, and fails open.

This is NOT reference behavior (the reference has no such filter) and is
OFF by default; enable with ``engine.music_filter`` / CLI
``--music-filter [THRESHOLD]``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

# Analysis frame: 1024-sample Hann window, 256 hop at the 22050 Hz
# internal rate -> ~86 frames/s envelope resolution.
_N_FFT = 1024
_HOP = 256
# Onset envelope band limit (Hz): beat onsets are kick/bass-dominated.
_FLUX_FMAX = 1500.0
# Beat-lag search range, seconds (260 down to 50 BPM).
_LAG_LO_S = 0.23
_LAG_HI_S = 1.2
# Context the score needs: beat autocorrelation at 1.2 s lags needs a few
# periods of signal to mean anything.
MIN_CONTEXT_SECONDS = 2.5
CONTEXT_SECONDS = 4.0
#: Default drop threshold: above the worst-scoring true-speech context
#: across the full measured grid sweep (max 0.815 over 1,763 regions,
#: 24 conditions x 2 generators), well below the pure-music medians
#: (>= 1.0); the house-fire drop rate is identical at 0.80 and 0.85.
DEFAULT_THRESHOLD = 0.85


def _stft_logmag(x: np.ndarray) -> Optional[np.ndarray]:
    n = (len(x) - _N_FFT) // _HOP + 1
    if n < 2:
        return None
    idx = np.arange(_N_FFT)[None, :] + _HOP * np.arange(n)[:, None]
    frames = x[idx] * np.hanning(_N_FFT)[None, :].astype(np.float32)
    return np.log1p(np.abs(np.fft.rfft(frames, axis=1))).astype(np.float32)


def _beat_info(flux: np.ndarray, fps: float) -> Optional[dict]:
    """Beat strength / harmonic / sharpness / lag of one onset envelope."""
    flux = flux - flux.mean()
    sd = float(flux.std())
    if sd <= 0.0:
        return None
    flux = flux / sd
    t = len(flux)
    ac = np.correlate(flux, flux, "full")[t - 1:] / t
    ac0 = float(ac[0]) or 1.0
    ac = ac / ac0
    lag0 = int(_LAG_LO_S * fps)
    lag1 = min(int(_LAG_HI_S * fps), t - 1)
    if lag1 <= lag0:
        return None
    window = ac[lag0:lag1]
    best = lag0 + int(np.argmax(window))
    beat = float(window.max())
    beat2 = float(ac[2 * best]) if 2 * best < t else 0.0
    a, b = int(best * 0.75), int(best * 1.25)
    neighborhood = np.r_[ac[a:int(best * 0.95)],
                         ac[int(best * 1.05) + 1:b + 1]]
    sharp = beat - float(np.median(neighborhood)) if len(neighborhood) else 0.0
    return {"beat": beat, "beat2": beat2, "lag": best, "sharp": sharp}


def music_score(x: np.ndarray, sr: int) -> float:
    """Rhythmicity score of a mono waveform; higher = more music-like.

    Returns -inf when there is not enough signal to score (callers keep
    the region in that case — fail open).
    """
    x = np.asarray(x, np.float32)
    if len(x) < int(MIN_CONTEXT_SECONDS * sr):
        return float("-inf")
    L = _stft_logmag(x)
    if L is None or L.shape[0] < 32:
        return float("-inf")
    fps = sr / _HOP
    # onset envelope: half-wave-rectified spectral flux, low band only
    k_max = int(_FLUX_FMAX * _N_FFT / sr)
    flux = np.maximum(0.0, np.diff(L, axis=0))[:, :k_max].sum(axis=1)
    bi = _beat_info(flux, fps)
    if bi is None:
        return float("-inf")
    # tempo stability: the beat must be independently present at (nearly)
    # the same lag in both halves of the context
    h = len(flux) // 2
    a, b = _beat_info(flux[:h], fps), _beat_info(flux[h:], fps)
    stab = 0.0
    if a and b and abs(a["lag"] - b["lag"]) <= max(2, 0.08 * bi["lag"]):
        stab = min(a["beat"], b["beat"])
    return (bi["beat"] + 0.5 * max(bi["beat2"], 0.0)
            + 0.5 * max(bi["sharp"], 0.0) + 0.5 * stab)


def context_bounds(
    start: float, end: float, duration: float,
    context_seconds: float = CONTEXT_SECONDS,
) -> Tuple[float, float]:
    """Extend [start, end) symmetrically to >= context_seconds, clamped to
    [0, duration] (the clamp may shift the window off-center at edges)."""
    need = max(0.0, context_seconds - (end - start))
    s = start - need / 2.0
    e = end + need / 2.0
    if s < 0.0:
        e = min(duration, e - s)
        s = 0.0
    if e > duration:
        s = max(0.0, s - (e - duration))
        e = duration
    return s, e


def filter_intervals(
    intervals: Sequence[Tuple[float, float]],
    read_context: Callable[[float, float], Optional[np.ndarray]],
    sr: int,
    duration: float,
    threshold: float = DEFAULT_THRESHOLD,
) -> Tuple[List[Tuple[float, float]], List[float]]:
    """Score each interval's context; drop those scoring >= threshold.

    ``read_context(s, e)`` returns the mono waveform for [s, e) seconds at
    ``sr`` (or None on failure -> region kept).  Returns (kept intervals,
    all scores aligned with the input order).
    """
    kept: List[Tuple[float, float]] = []
    scores: List[float] = []
    for (s, e) in intervals:
        cs, ce = context_bounds(
            max(0.0, float(s)), min(duration, float(e)), duration)
        audio = None
        if ce - cs >= MIN_CONTEXT_SECONDS:
            try:
                audio = read_context(cs, ce)
            except Exception:  # noqa: BLE001 — fail open: keep the region
                audio = None
        score = music_score(audio, sr) if audio is not None else float("-inf")
        scores.append(score)
        if not score >= threshold:
            kept.append((s, e))
    return kept, scores
