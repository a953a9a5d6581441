"""Second, independently-written synthetic eval generator (out-of-family).

A copy of the JAX package's ``train/synth2.py``, sample for sample.  The
detector is trained on recordings of the ``train/synth.py`` family; this
generator is the out-of-family check: every DSP choice is deliberately
different from synth.py so that agreement between the two eval sets is
evidence of generalization, not memorization of one synthesizer's
artifacts.

Independent choices (synth.py → synth2.py):

  * glottal source: impulse train + −6 dB/oct integrator → **LF-model flow
    derivative** sampled per pitch period (exponentially growing sinusoid
    open phase + exponential return phase)
  * vocal tract: parallel 2nd-order resonators (lfilter), fixed per-syllable
    formants → **cascade biquad sections (sosfilt) with time-varying
    (diphthong) formant tracks**, Hillenbrand-style vowel targets
  * consonants: band-noise fricative onsets → fricatives via **FIR
    (firwin) spectral shaping** plus **plosive bursts** (closure gap +
    transient)
  * noise field: 1/f spectral shaping + interp AM → **Ornstein–Uhlenbeck
    amplitude fields, FIR-shaped hiss, shot-noise pulse processes, harmonic
    animal calls** (corvid squawks are a deliberate harmonic confuser)
  * mixing: per-event RMS-SNR against the local bed (same *definition*, the
    parity contract) but independently coded, with a non-overlapping event
    planner; labels come from the utterance PLAN, not from thresholding an
    activity array
  * levels: bed at random depth, recording normalized to a target RMS with
    a true-peak ceiling (synth.py peak-normalizes)

Reference intent being approximated: real PeoplesSpeech speech over real
ESC-50 noise (voice_activity.py:257-297).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy import signal

SR = 22050

# Hillenbrand et al. (1995) adult-male steady-state targets, rounded (Hz).
# Different source and values than synth.py's Peterson–Barney table.
_VOWELS2 = {
    "iy": (342, 2322, 3000),
    "ih": (427, 2034, 2684),
    "eh": (580, 1799, 2605),
    "ae": (588, 1952, 2601),
    "ah": (768, 1333, 2522),
    "aw": (652, 997, 2538),
    "uw": (378, 997, 2343),
    "uh": (469, 1122, 2434),
    "er": (474, 1379, 1710),
}
_VOWEL_KEYS = sorted(_VOWELS2)


# --------------------------------------------------------------------------
# LF glottal source
# --------------------------------------------------------------------------

def _lf_period(T: int, oq: float, am: float, ta_frac: float) -> np.ndarray:
    """One pitch period of LF-model glottal flow *derivative*.

    T samples; ``oq`` open quotient (Te/T), ``am`` asymmetry (peak position
    within the open phase), ``ta_frac`` return-phase time constant as a
    fraction of T.  Open phase: E0·e^{αt}·sin(πt/(oq·am·2·T'))-style growing
    sinusoid reaching the negative excitation peak at Te; return phase:
    exponential recovery to zero (abrupt-closure residual removed so each
    period integrates to ≈0 flow).
    """
    Te = max(2, int(oq * T))
    Ta = max(1.0, ta_frac * T)
    t = np.arange(Te, dtype=np.float64)
    # growing sinusoid: zero flow derivative at t=0, negative excitation
    # extremum near Te (wg places the sign flip at am·Te)
    wg = np.pi / (am * Te)
    alpha = 3.0 / Te
    open_phase = np.exp(alpha * (t - Te)) * np.sin(wg * t)
    # normalize so the closing extremum is −1
    m = np.min(open_phase)
    if m < 0:
        open_phase = open_phase / (-m)
    ret_len = T - Te
    eps = 1.0 / Ta
    tr = np.arange(ret_len, dtype=np.float64)
    ee = open_phase[-1] if Te > 0 else -1.0
    ret = ee * np.exp(-eps * tr)
    out = np.concatenate([open_phase, ret])
    out -= out.mean()  # ≈ zero net flow per period
    return out.astype(np.float32)


def _lf_source(f0_track: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Concatenate LF periods following a per-sample f0 track (Hz)."""
    n = len(f0_track)
    out = np.zeros(n + 4096, np.float32)
    oq = float(rng.uniform(0.45, 0.75))
    am = float(rng.uniform(0.55, 0.8))
    ta = float(rng.uniform(0.004, 0.03))
    pos = 0
    while pos < n:
        f0 = float(f0_track[min(pos, n - 1)])
        T = max(16, int(round(SR / max(40.0, f0))))
        # jitter: period-to-period f0 perturbation
        T = max(16, int(T * (1.0 + 0.01 * rng.standard_normal())))
        pulse = _lf_period(T, oq, am, ta)
        # shimmer
        out[pos: pos + T] += pulse[:T] * (1.0 + 0.1 * rng.standard_normal())
        pos += T
    return out[:n]


# --------------------------------------------------------------------------
# cascade vocal tract with moving formants
# --------------------------------------------------------------------------

def _formant_sos(formants, bws) -> np.ndarray:
    """Cascade of 2nd-order all-pole sections (unity DC gain each)."""
    sections = []
    for f, bw in zip(formants, bws):
        r = np.exp(-np.pi * bw / SR)
        w = 2 * np.pi * f / SR
        a = [1.0, -2 * r * np.cos(w), r * r]
        g = sum(a)  # DC gain of 1/A(z) is 1/sum(a)
        sections.append([g, 0.0, 0.0, *a])
    return np.asarray(sections, np.float64)


def _apply_moving_tract(src: np.ndarray, f_from, f_to, rng) -> np.ndarray:
    """Filter through a cascade whose formants glide f_from→f_to.

    Implemented as 6 sub-segments with interpolated targets, each filtered
    with its own cascade (state carried across segments per section), which
    approximates a smoothly time-varying tract without per-sample updates.
    """
    n = len(src)
    n_seg = 6
    bounds = np.linspace(0, n, n_seg + 1).astype(int)
    bws = (50.0 + 30.0 * rng.uniform(), 80.0 + 40.0 * rng.uniform(),
           120.0 + 60.0 * rng.uniform())
    out = np.empty(n, np.float64)
    zi = None
    for k in range(n_seg):
        a = (k + 0.5) / n_seg
        fmt = tuple((1 - a) * np.asarray(f_from) + a * np.asarray(f_to))
        sos = _formant_sos(fmt, bws)
        if zi is None:
            zi = np.zeros((sos.shape[0], 2))
        seg = src[bounds[k]: bounds[k + 1]]
        y, zi = signal.sosfilt(sos, seg, zi=zi)
        out[bounds[k]: bounds[k + 1]] = y
    return out


def _fricative(n: int, rng: np.random.Generator) -> np.ndarray:
    """FIR-shaped sibilance (independent of synth.py's butter band-noise)."""
    lo = float(rng.uniform(2800.0, 5200.0))
    taps = signal.firwin(97, lo, fs=SR, pass_zero=False)
    x = np.convolve(rng.standard_normal(n + 96), taps, mode="valid")[:n]
    env = np.minimum(1.0, np.arange(n) / max(1, int(0.01 * SR)))
    env *= np.minimum(1.0, (n - np.arange(n)) / max(1, int(0.02 * SR)))
    x = x * env
    return (x / (np.abs(x).max() + 1e-9)).astype(np.float32)


def _plosive(rng: np.random.Generator) -> np.ndarray:
    """Closure gap + broadband burst + short aspiration."""
    gap = np.zeros(int(rng.uniform(0.02, 0.06) * SR), np.float32)
    bn = int(rng.uniform(0.005, 0.02) * SR)
    burst = rng.standard_normal(bn).astype(np.float32)
    burst *= np.exp(-np.arange(bn) / (0.25 * bn + 1.0)).astype(np.float32)
    return np.concatenate([gap, burst / (np.abs(burst).max() + 1e-9)])


def speech2(
    rng: np.random.Generator, n_samples: int
) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """Speech-like audio; returns (audio, [(start, end) sample spans]).

    Spans come from the utterance PLAN (every generated syllable run),
    not from thresholding the rendered signal.
    """
    audio = np.zeros(n_samples, np.float32)
    spans: List[Tuple[int, int]] = []

    f0_base = float(rng.uniform(95.0, 230.0))
    vt = float(rng.uniform(0.9, 1.12))

    pos = int(rng.integers(0, SR // 5))
    while pos < n_samples - SR // 10:
        utt_start = pos
        n_syll = int(rng.integers(2, 8))
        for si in range(n_syll):
            if pos >= n_samples - SR // 20:
                break
            piece_type = rng.uniform()
            if piece_type < 0.18:
                seg = _plosive(rng) * float(rng.uniform(0.3, 0.6))
            elif piece_type < 0.38:
                seg = _fricative(int(rng.uniform(0.05, 0.14) * SR), rng)
                seg = seg * float(rng.uniform(0.25, 0.5))
            else:
                v_len = int(rng.uniform(0.09, 0.30) * SR)
                v_len = min(v_len, n_samples - pos)
                if v_len < 128:
                    break
                # intonation: phrase-level fall + accent bump
                tt = np.linspace(0.0, 1.0, v_len)
                f0 = f0_base * (1.05 - 0.15 * tt + 0.1 * np.exp(
                    -((tt - rng.uniform(0.2, 0.8)) ** 2) / 0.02))
                src = _lf_source(f0, rng)
                # aspiration noise mixed at the source
                src = src + float(rng.uniform(0.01, 0.06)) * \
                    rng.standard_normal(v_len).astype(np.float32)
                va = np.asarray(_VOWELS2[_VOWEL_KEYS[rng.integers(len(_VOWEL_KEYS))]])
                vb = np.asarray(_VOWELS2[_VOWEL_KEYS[rng.integers(len(_VOWEL_KEYS))]])
                if rng.uniform() < 0.5:
                    vb = va  # monophthong
                y = _apply_moving_tract(src, va * vt, vb * vt, rng)
                # lip radiation (first difference)
                y = np.diff(y, prepend=y[0])
                env = np.ones(v_len)
                at = max(4, int(0.008 * SR))
                env[:at] = np.linspace(0, 1, at)
                dc = max(4, min(v_len // 2, int(rng.uniform(0.02, 0.06) * SR)))
                env[-dc:] *= np.linspace(1, 0, dc)
                y = y * env
                seg = (y / (np.abs(y).max() + 1e-9)).astype(np.float32)
                seg *= float(rng.uniform(0.6, 1.0))
            take = min(len(seg), n_samples - pos)
            audio[pos: pos + take] += seg[:take]
            pos += take
            if rng.uniform() < 0.3:
                pos += int(rng.uniform(0.01, 0.05) * SR)
        spans.append((utt_start, min(pos, n_samples)))
        pos += int(rng.uniform(0.2, 1.4) * SR)

    peak = np.abs(audio).max()
    if peak > 0:
        audio /= peak
    return audio, spans


# --------------------------------------------------------------------------
# environment textures (independent implementations)
# --------------------------------------------------------------------------

TEXTURES2 = ("leaves", "surf", "crickets", "corvid", "drone", "patter")


def _ou_field(rng, n: int, tau_s: float) -> np.ndarray:
    """Ornstein–Uhlenbeck amplitude field (mean 1, slow wander)."""
    k = int(max(1, tau_s * SR / 64))
    m = n // 64 + 2
    theta = 1.0 / k
    x = np.empty(m)
    x[0] = 0.0
    # AR(1) recursion x[i] = x[i-1]*(1-theta) + sqrt(theta)*z[i] as one
    # lfilter call — bit-identical to the scalar loop (verified across
    # seeds/lengths) and ~3x faster on the coarse grid
    x[1:] = signal.lfilter([np.sqrt(theta)], [1.0, theta - 1.0],
                           rng.standard_normal(m - 1))
    field = np.repeat(x, 64)[:n]
    return (1.0 + 0.5 * np.tanh(field)).astype(np.float32)


def texture2(rng: np.random.Generator, n: int, kind: Optional[str] = None) -> np.ndarray:
    if kind is None:
        kind = TEXTURES2[rng.integers(len(TEXTURES2))]

    if kind == "leaves":
        taps = signal.firwin(129, 900.0, fs=SR, pass_zero=False)
        hiss = np.convolve(rng.standard_normal(n + 128), taps, "valid")[:n]
        out = hiss * _ou_field(rng, n, rng.uniform(0.3, 1.5))
    elif kind == "surf":
        taps = signal.firwin(129, 700.0, fs=SR)
        low = np.convolve(rng.standard_normal(n + 128), taps, "valid")[:n]
        swell = _ou_field(rng, n, rng.uniform(3.0, 8.0)) ** 2
        out = low * swell
    elif kind == "crickets":
        out = np.zeros(n, np.float32)
        f = rng.uniform(3800, 6500)
        rate = rng.uniform(8, 25)
        t = np.arange(int(0.012 * SR)) / SR
        blip = np.sin(2 * np.pi * f * t) * np.exp(-t * 600)
        starts = np.cumsum(rng.exponential(SR / rate, int(n / SR * rate * 2))).astype(int)
        for s in starts[starts < n - len(blip)]:
            out[s: s + len(blip)] += blip.astype(np.float32)
    elif kind == "corvid":
        # harmonic squawks: the deliberate voiced confuser
        out = np.zeros(n, np.float32)
        n_calls = max(1, int(n / SR * rng.uniform(0.2, 1.5)))
        for _ in range(n_calls):
            dur = int(rng.uniform(0.15, 0.5) * SR)
            at = int(rng.integers(0, max(1, n - dur)))
            f0 = rng.uniform(500, 1100)
            t = np.arange(dur) / SR
            y = np.zeros(dur)
            for h in range(1, 7):
                y += np.sin(2 * np.pi * f0 * h * t +
                            3.0 * np.sin(2 * np.pi * rng.uniform(15, 40) * t)) / h
            y *= signal.windows.tukey(dur, 0.4)
            # clamp to the bed: for n shorter than one call (sub-0.5 s
            # beds) the write slice silently truncates, so truncate the
            # call to match instead of broadcasting into a ValueError
            seg = (0.4 * y).astype(np.float32)[: n - at]
            out[at: at + len(seg)] += seg
    elif kind == "drone":
        t = np.arange(n) / SR
        y = np.zeros(n)
        for f in rng.uniform(38, 130, 6):
            y += rng.uniform(0.2, 1.0) * np.sin(
                2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
        taps = signal.firwin(65, 350.0, fs=SR)
        bed = np.convolve(rng.standard_normal(n + 64), taps, "valid")[:n]
        out = (y / 6 + 0.4 * bed) * _ou_field(rng, n, 2.0)
    elif kind == "patter":
        # Poisson impulses through a narrow resonance (drips on a surface)
        imp = np.zeros(n, np.float32)
        rate = rng.uniform(3, 30)
        at = np.cumsum(rng.exponential(SR / rate, int(n / SR * rate * 2))).astype(int)
        at = at[at < n]
        imp[at] = rng.uniform(0.2, 1.0, len(at)).astype(np.float32)
        f = rng.uniform(600, 2500)
        r = np.exp(-np.pi * 80.0 / SR)
        out = signal.lfilter([1.0], [1, -2 * r * np.cos(2 * np.pi * f / SR), r * r],
                             imp).astype(np.float32)
    else:  # pragma: no cover
        raise ValueError(kind)

    peak = np.abs(out).max()
    return (out / peak).astype(np.float32) if peak > 0 else np.zeros(n, np.float32)


# --------------------------------------------------------------------------
# mixer / labeled recording
# --------------------------------------------------------------------------

def field_recording2(
    rng: np.random.Generator,
    seconds: float,
    sr: int = 32000,
    speech_events: Tuple[int, int] = (2, 8),
    snr_db: Tuple[float, float] = (0.0, 20.0),
) -> Tuple[np.ndarray, List[Tuple[float, float]]]:
    """Labeled outdoor recording from the v2 generator.

    Same call shape as synth.synth_field_recording so the eval harness can
    swap generators; internals are independent (planner-placed
    non-overlapping events, plan-derived labels, RMS-target leveling).
    """
    n22 = int(seconds * SR)
    bed = 0.6 * texture2(rng, n22) + 0.4 * texture2(rng, n22)
    bed_gain = float(rng.uniform(0.05, 0.25))
    audio = bed_gain * bed

    # plan non-overlapping event slots first
    n_events = int(rng.integers(speech_events[0], speech_events[1] + 1))
    slots: List[Tuple[int, int]] = []
    tries = 0
    while len(slots) < n_events and tries < 50:
        tries += 1
        dur = int(min(rng.uniform(1.0, 6.0) * SR, n22))
        at = int(rng.integers(0, max(1, n22 - dur)))
        if all(at + dur + SR // 2 <= s or at >= e + SR // 2 for s, e in slots):
            slots.append((at, at + dur))
    slots.sort()

    intervals: List[Tuple[float, float]] = []
    for at, end in slots:
        n = end - at
        sp, spans = speech2(rng, n)
        if not spans:
            continue
        voiced = np.zeros(n, bool)
        for s, e in spans:
            voiced[s:e] = True
        snr = float(rng.uniform(*snr_db))
        bed_rms = float(np.sqrt(np.mean(audio[at:end] ** 2) + 1e-12))
        sp_rms = float(np.sqrt(np.mean(sp[voiced] ** 2) + 1e-12))
        audio[at:end] += bed_rms * 10 ** (snr / 20.0) / sp_rms * sp
        for s, e in spans:
            intervals.append(((at + s) / SR, (at + e) / SR))

    # merge plan fragments the same way labels are conventionally merged
    from ..engine.regions import merge_intervals

    merged = merge_intervals(intervals, gap=0.3)

    # RMS-target leveling with a hard true-peak ceiling
    rms = float(np.sqrt(np.mean(audio ** 2) + 1e-12))
    audio = audio * (0.06 / rms)
    peak = float(np.abs(audio).max())
    if peak > 0.99:
        audio *= 0.99 / peak

    if sr == SR:
        return audio.astype(np.float32), merged
    from ..io.resample import resample

    native = resample(audio.astype(np.float32), SR, sr)
    return native.astype(np.float32), merged
