"""Synthetic training corpus: formant speech + ecological soundscapes.

The reference trains on PeoplesSpeech (speech) mixed into ESC-50
(environmental noise) — its latent loaders are voice_activity.py:257-297.
Neither dataset is redistributable inside this build environment, so this
module synthesizes acoustically analogous material from first principles:

  * ``synth_speech``      — source-filter (formant) speech: a glottal pulse
    train with pitch contour/jitter, filtered through per-syllable vowel
    formant resonators, with fricative onsets/offsets, syllable amplitude
    envelopes, utterance/pause structure.  Returns sample-accurate voice
    activity alongside the audio, which is what makes a labeled F1 eval set
    possible at all.
  * ``synth_environment`` — wind / rain / stream / bird chirps / insects /
    low rumble, the confusers an outdoor recorder actually picks up (bird
    FM sweeps are the classic speech-detector false positive).

Everything is vectorized numpy + scipy.signal.lfilter (host side, one-time
corpus generation); training itself consumes pre-materialized clip pools on
device (train/device_data.py).

A copy of the JAX package's ``train/synth.py``: the same seed gives
bit-identical pools (tests/test_torch_train_synth.py), and
``synth_field_recording`` builds the labeled recordings that
``train/evaluate.py`` scores.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy import signal

from ..engine.regions import merge_intervals
from ..io.resample import resample

SR = 22050
CLIP = SR * 3


# --------------------------------------------------------------------------
# formant speech
# --------------------------------------------------------------------------

# steady-state vowel formant targets (Hz), classic Peterson–Barney ballpark
_VOWELS = np.array(
    [
        # F1    F2    F3
        [730, 1090, 2440],  # ɑ
        [270, 2290, 3010],  # i
        [300, 870, 2240],   # u
        [530, 1840, 2480],  # ɛ
        [570, 840, 2410],   # ɔ
        [440, 1020, 2240],  # ʊ
        [660, 1720, 2410],  # æ
        [490, 1350, 1690],  # ɝ
    ],
    np.float64,
)


def _resonator(x: np.ndarray, freq: float, bw: float, sr: int = SR) -> np.ndarray:
    """Second-order all-pole resonance at ``freq`` with bandwidth ``bw``."""
    r = np.exp(-np.pi * bw / sr)
    w = 2.0 * np.pi * freq / sr
    a = [1.0, -2.0 * r * np.cos(w), r * r]
    b = [(1.0 - r) * np.sqrt(1.0 - 2.0 * r * np.cos(2.0 * w) + r * r)]
    return signal.lfilter(b, a, x)


def _glottal_pulses(n: int, f0: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Impulse train whose instantaneous rate follows f0 (per-sample Hz)."""
    phase = np.cumsum(f0) / SR
    pulses = np.zeros(n, np.float32)
    idx = np.searchsorted(phase, np.arange(1, int(phase[-1]) + 1))
    idx = idx[idx < n]
    # shimmer: per-pulse amplitude variation
    pulses[idx] = 1.0 + 0.15 * rng.standard_normal(len(idx))
    return pulses


def synth_speech(
    rng: np.random.Generator,
    n_samples: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Speech-like audio of length ``n_samples`` at 22050 Hz.

    Returns (audio float32, activity bool per sample). Activity covers every
    syllable (voiced core + consonant margins); pauses are digital silence.
    """
    audio = np.zeros(n_samples, np.float32)
    active = np.zeros(n_samples, bool)

    # speaker: pitch register + vocal-tract length scale
    f0_base = float(rng.uniform(85.0, 255.0))
    vt_scale = float(rng.uniform(0.85, 1.15))
    breathiness = float(rng.uniform(0.01, 0.08))

    pos = int(rng.integers(0, SR // 4))
    while pos < n_samples - SR // 10:
        # one utterance: 1-8 syllables
        n_syll = int(rng.integers(1, 9))
        declination = 1.0
        for _ in range(n_syll):
            if pos >= n_samples - SR // 20:
                break
            syl_len = int(rng.uniform(0.08, 0.32) * SR)
            syl_len = min(syl_len, n_samples - pos)
            seg = np.zeros(syl_len, np.float32)

            # optional fricative onset (~30%)
            fric_len = 0
            if rng.uniform() < 0.3 and syl_len > int(0.06 * SR):
                fric_len = min(int(rng.uniform(0.03, 0.08) * SR), syl_len // 2)
                noise = rng.standard_normal(fric_len)
                sos = signal.butter(
                    2, [min(3000, SR // 2 - 2000), SR // 2 - 500],
                    btype="band", fs=SR, output="sos",
                )
                fric = signal.sosfilt(sos, noise).astype(np.float32)
                fric *= np.hanning(fric_len).astype(np.float32)
                seg[:fric_len] = 0.35 * fric / (np.abs(fric).max() + 1e-9)

            # voiced vowel core
            v_len = syl_len - fric_len
            if v_len > 64:
                f0_contour = f0_base * declination * (
                    1.0
                    + 0.12 * np.sin(np.linspace(0, np.pi, v_len) * rng.uniform(0.5, 2.0))
                    + 0.02 * rng.standard_normal(v_len).cumsum() / np.sqrt(np.arange(1, v_len + 1))
                )
                f0_contour = np.clip(f0_contour, 60.0, 400.0)
                src = _glottal_pulses(v_len, f0_contour, rng)
                # spectral tilt: integrate pulses once (−6 dB/oct like glottal flow)
                src = signal.lfilter([1.0], [1.0, -0.96], src).astype(np.float32)
                src += breathiness * rng.standard_normal(v_len).astype(np.float32)

                vowel = _VOWELS[rng.integers(len(_VOWELS))] * vt_scale
                vowel = vowel * rng.uniform(0.92, 1.08, 3)
                y = np.zeros(v_len)
                for fmt, bw, g in zip(vowel, (60.0, 90.0, 140.0), (1.0, 0.63, 0.3)):
                    y = y + g * _resonator(src, float(fmt), bw)
                # radiation: differentiate (+6 dB/oct)
                y = np.diff(y, prepend=0.0)
                env = np.ones(v_len)
                a = min(v_len // 2, max(8, int(0.012 * SR)))
                env[:a] = np.linspace(0, 1, a)
                d = min(v_len // 2, max(8, int(rng.uniform(0.01, 0.05) * SR)))
                env[-d:] *= np.linspace(1, 0, d)
                seg[fric_len:] = (y * env / (np.abs(y).max() + 1e-9)).astype(np.float32)

            amp = float(rng.uniform(0.5, 1.0))
            audio[pos : pos + syl_len] += amp * seg
            active[pos : pos + syl_len] = True
            pos += syl_len
            declination *= rng.uniform(0.95, 1.0)
            # short intra-word gap (~40%)
            if rng.uniform() < 0.4:
                pos += int(rng.uniform(0.01, 0.06) * SR)
        # inter-utterance pause
        pos += int(rng.uniform(0.15, 1.2) * SR)

    peak = np.abs(audio).max()
    if peak > 0:
        audio /= peak
    return audio, active


# --------------------------------------------------------------------------
# ecological soundscapes
# --------------------------------------------------------------------------

ENVIRONMENT_KINDS = ("wind", "rain", "stream", "birds", "insects", "rumble",
                     "calls", "hum")

# Confuser kinds OUTSIDE the default draw: adding a kind to
# ENVIRONMENT_KINDS silently changes both the training distribution AND
# every seeded eval set built on synth_field_recording, invalidating
# comparability with committed evidence grids.  Extra kinds are therefore
# opt-in (make_pools(extra_kinds=...), CLI `train --noise-extra`) until a
# fine-tune against them passes the full quality gate.
#   "music": the real-audio probe (docs/QUALITY_r03_realaudio.json) showed
#   the checkpoint flags ~50% of a house-music loop as speech.
#   The third-family kinds (train/synth3.py: granular/drone/impact_chain/
#   crackle — independent DSP from both generators; VERDICT r3 #7) are
#   likewise opt-in TRAIN-ONLY confusers.
EXTRA_ENVIRONMENT_KINDS = ("music", "granular", "drone", "impact_chain",
                           "crackle")


def _colored_noise(rng, n: int, alpha: float) -> np.ndarray:
    """1/f^alpha noise via spectral shaping."""
    spec = np.fft.rfft(rng.standard_normal(n))
    f = np.maximum(np.fft.rfftfreq(n, 1.0 / SR), 1.0)
    out = np.fft.irfft(spec / f ** (alpha / 2.0), n)
    return (out / (np.abs(out).max() + 1e-12)).astype(np.float32)


def synth_environment(
    rng: np.random.Generator, n_samples: int, kind: Optional[str] = None
) -> np.ndarray:
    """One environmental texture (or a random one) of length ``n_samples``."""
    if kind is None:
        kind = ENVIRONMENT_KINDS[rng.integers(len(ENVIRONMENT_KINDS))]
    if kind in ("granular", "drone", "impact_chain", "crackle"):
        from . import synth3

        return synth3.texture3(rng, n_samples, kind)

    if kind == "wind":
        base = _colored_noise(rng, n_samples, 2.0)
        # slow gust amplitude modulation
        gust = _colored_noise(rng, max(64, n_samples // 256), 1.0)
        am = 0.55 + 0.45 * np.interp(
            np.linspace(0, 1, n_samples), np.linspace(0, 1, len(gust)), gust
        )
        out = base * am.astype(np.float32)

    elif kind == "rain":
        # impulsive drops + broadband hiss
        hiss = 0.25 * _colored_noise(rng, n_samples, 0.5)
        drops = np.zeros(n_samples, np.float32)
        n_drops = int(n_samples / SR * rng.uniform(40, 400))
        at = rng.integers(0, n_samples, n_drops)
        drops[at] = rng.uniform(0.2, 1.0, n_drops).astype(np.float32)
        decay = np.exp(-np.arange(64) / rng.uniform(4, 16)).astype(np.float32)
        out = hiss + signal.fftconvolve(drops, decay)[:n_samples]

    elif kind == "stream":
        sos = signal.butter(2, [400, 4000], btype="band", fs=SR, output="sos")
        out = signal.sosfilt(sos, rng.standard_normal(n_samples)).astype(np.float32)
        warble = 1.0 + 0.2 * np.sin(
            2 * np.pi * rng.uniform(0.3, 2.0) * np.arange(n_samples) / SR
        )
        out = out * warble.astype(np.float32)

    elif kind == "birds":
        out = np.zeros(n_samples, np.float32)
        t_all = np.arange(n_samples) / SR
        n_chirps = max(1, int(n_samples / SR * rng.uniform(0.5, 4.0)))
        for _ in range(n_chirps):
            # clamp to the clip: a chirp longer than the whole clip made
            # out[at:at+dur] += chirp a broadcast ValueError for sub-0.4 s
            # environments (review r3 batch 14; same clamp as speech events)
            dur = min(int(rng.uniform(0.05, 0.4) * SR), n_samples)
            at = int(rng.integers(0, max(1, n_samples - dur)))
            f_lo = rng.uniform(1800, 5000)
            f_hi = f_lo * rng.uniform(1.1, 2.2)
            tt = t_all[:dur]
            # FM sweep with trill
            f = np.linspace(f_lo, f_hi, dur) * (
                1 + 0.05 * np.sin(2 * np.pi * rng.uniform(10, 40) * tt)
            )
            chirp = np.sin(2 * np.pi * np.cumsum(f) / SR) * np.hanning(dur)
            out[at : at + dur] += rng.uniform(0.3, 1.0) * chirp.astype(np.float32)

    elif kind == "insects":
        t = np.arange(n_samples) / SR
        f_c = rng.uniform(3500, 7000)
        am = 0.5 * (1 + signal.square(2 * np.pi * rng.uniform(5, 30) * t, duty=0.5))
        out = (np.sin(2 * np.pi * f_c * t) * am).astype(np.float32)
        out += 0.05 * _colored_noise(rng, n_samples, 1.0)

    elif kind == "rumble":
        sos = signal.butter(4, 150, btype="low", fs=SR, output="sos")
        bursts = _colored_noise(rng, n_samples, 1.5)
        env = np.clip(_colored_noise(rng, max(64, n_samples // 512), 1.0), 0, None)
        am = np.interp(np.linspace(0, 1, n_samples), np.linspace(0, 1, len(env)), env)
        out = signal.sosfilt(sos, bursts).astype(np.float32) * (0.3 + am).astype(
            np.float32
        )

    elif kind == "calls":
        # Harmonic animal calls (corvid/jay register): a pulse train through
        # vocal-tract-style resonators with roughness AM — the VOICED
        # confuser a field recorder picks up.  Added in round 3 after the
        # out-of-family eval (train/synth2.py corvid texture) showed the
        # round-2 checkpoint false-alarming on harmonic calls it had never
        # seen; the implementation here (excitation-filter) is deliberately
        # different from synth2's additive sine stack.  f0 300–1300 Hz sits
        # ABOVE the speech register (85–255 Hz), which is the discriminant
        # training can learn.
        out = np.zeros(n_samples, np.float32)
        n_calls = max(1, int(n_samples / SR * rng.uniform(0.3, 2.0)))
        for _ in range(n_calls):
            dur = min(int(rng.uniform(0.1, 0.6) * SR), n_samples)  # see birds
            at = int(rng.integers(0, max(1, n_samples - dur)))
            f0 = float(rng.uniform(300.0, 1300.0))
            sweep = 1.0 + rng.uniform(-0.25, 0.25) * np.linspace(0, 1, dur)
            src = _glottal_pulses(dur, np.clip(f0 * sweep, 200.0, 2000.0), rng)
            y = np.zeros(dur)
            for fc, bw, g in ((rng.uniform(800, 1800), 250.0, 1.0),
                              (rng.uniform(2000, 3500), 400.0, 0.5)):
                y = y + g * _resonator(src, float(fc), bw)
            rough = 1.0 + 0.5 * np.sin(
                2 * np.pi * rng.uniform(40, 120) * np.arange(dur) / SR)
            y = y * rough * signal.windows.tukey(dur, 0.5)
            peak = np.abs(y).max()
            if peak > 0:
                out[at: at + dur] += (
                    rng.uniform(0.4, 1.0) * y / peak).astype(np.float32)

    elif kind == "hum":
        # Electrical mains hum: a drifting 50-or-60 Hz fundamental with a
        # buzzy odd-harmonic stack (triode/transformer saturation puts the
        # energy in odd harmonics) plus slow level wobble.  Added in round 3:
        # the degradation grid's worst out-of-family condition was v2+hum
        # (frame F1 0.878, docs/QUALITY_r03.json) — the 100-250 Hz harmonics
        # land exactly in the speech-F0 register and false-fire the round-3
        # checkpoint.  Implementation is deliberately independent of the
        # eval-side train/degrade.py::hum (fixed 50 Hz, harmonics 1-3, even
        # included, no drift) so train and eval stay uncorrelated.
        t = np.arange(n_samples) / SR
        f_base = float(rng.choice((50.0, 60.0)))
        # mains frequency wanders a few tens of mHz; phase drift decorrelates
        drift = 1.0 + 1e-3 * np.interp(
            np.linspace(0, 1, n_samples),
            np.linspace(0, 1, 64),
            rng.standard_normal(64).cumsum() * 0.1)
        phase = 2 * np.pi * np.cumsum(f_base * drift) / SR
        out = np.zeros(n_samples)
        for k in (1, 3, 5, 7, 9, 11):
            out += rng.uniform(0.5, 1.0) / k * np.sin(
                k * phase + rng.uniform(0, 2 * np.pi))
        wobble = 1.0 + 0.25 * np.sin(
            2 * np.pi * rng.uniform(0.05, 0.5) * t + rng.uniform(0, 2 * np.pi))
        out = (out * wobble).astype(np.float32)
        # a touch of broadband transformer buzz
        out += 0.03 * _colored_noise(rng, n_samples, 1.0)

    elif kind == "music":
        # Electronic music (the measured false-positive class,
        # docs/QUALITY_r03_realaudio.json): four-on-the-floor kick,
        # off-beat hats, and sustained harmonic chord stabs.  The
        # discriminants training can learn vs speech: metronomic timing,
        # pitch held constant WITHIN a note (no formant glides), and a
        # harmonic stack that doesn't move like a vocal tract.
        t_all = np.arange(n_samples) / SR
        beat = 60.0 / float(rng.uniform(95.0, 140.0))
        out = np.zeros(n_samples, np.float32)
        # kick: short exp-decaying sine with a pitch drop, every beat
        kdur = min(int(0.18 * SR), max(1, n_samples))
        kt = np.arange(kdur) / SR
        kf = rng.uniform(45.0, 75.0)
        kick = (np.sin(2 * np.pi * np.cumsum(
            kf * (1.0 + 2.5 * np.exp(-kt / 0.02))) / SR)
            * np.exp(-kt / 0.06)).astype(np.float32)
        for b in np.arange(0.0, n_samples / SR, beat):
            at = int(b * SR)
            n = min(kdur, n_samples - at)
            if n > 0:
                out[at:at + n] += 0.9 * kick[:n]
        # hats: 5-15 ms high-passed noise bursts on the off-beats
        sos_h = signal.butter(4, 5000, btype="high", fs=SR, output="sos")
        for b in np.arange(beat / 2.0, n_samples / SR, beat / 2.0):
            at = int(b * SR)
            n = min(int(rng.uniform(0.005, 0.015) * SR), n_samples - at)
            if n > 1:
                burst = signal.sosfilt(
                    sos_h, rng.standard_normal(n)) * np.exp(
                        -np.arange(n) / (0.004 * SR))
                out[at:at + n] += rng.uniform(0.1, 0.3) * burst.astype(
                    np.float32)
        # chord stabs: a saw-ish harmonic stack on root+third+fifth,
        # note changes on a 1-or-2-beat grid, constant pitch within a note
        note_len = beat * float(rng.choice((1.0, 2.0)))
        roots = 110.0 * 2.0 ** (rng.integers(-5, 8, size=64) / 12.0)
        chord = np.zeros(n_samples)
        for i, b in enumerate(np.arange(0.0, n_samples / SR, note_len)):
            at = int(b * SR)
            n = min(int(note_len * SR), n_samples - at)
            if n <= 1:
                continue
            f_root = float(roots[i % len(roots)])
            seg = np.zeros(n)
            tt = t_all[:n]
            for ratio in (1.0, 2.0 ** (4 / 12.0), 2.0 ** (7 / 12.0)):
                for k in range(1, 9):
                    f = f_root * ratio * k
                    if f < SR / 2 - 200:
                        seg += np.sin(2 * np.pi * f * tt
                                      + rng.uniform(0, 2 * np.pi)) / k
            env = np.minimum(1.0, np.arange(n) / (0.005 * SR)) * np.exp(
                -np.arange(n) / (rng.uniform(0.3, 1.2) * SR))
            chord[at:at + n] += seg * env
        cpeak = np.abs(chord).max()
        if cpeak > 0:
            out += (rng.uniform(0.35, 0.7) * chord / cpeak).astype(np.float32)

    else:  # pragma: no cover
        raise ValueError(f"unknown environment kind {kind!r}")

    peak = np.abs(out).max()
    return (out / peak).astype(np.float32) if peak > 0 else out.astype(np.float32)


# --------------------------------------------------------------------------
# pools
# --------------------------------------------------------------------------

def make_pools(
    rng: np.random.Generator, n_speech: int, n_noise: int,
    extra_kinds: Tuple[str, ...] = (), extra_frac: float = 0.2,
) -> Tuple[np.ndarray, np.ndarray]:
    """(n_speech, CLIP) speech clips and (n_noise, CLIP) environment clips.

    ``extra_kinds`` mixes opt-in confuser textures (EXTRA_ENVIRONMENT_KINDS,
    e.g. "music") into the LAST ``extra_frac`` of the noise pool — appended,
    not interleaved, so the default pools are bit-identical to the
    pre-``extra_kinds`` builder for the same seed (the committed
    checkpoint's training stream stays reproducible)."""
    if not 0.0 <= extra_frac <= 1.0:
        raise ValueError(f"extra_frac must be in [0, 1], got {extra_frac}")
    speech = np.stack([synth_speech(rng, CLIP)[0] for _ in range(n_speech)])
    n_extra = int(n_noise * extra_frac) if extra_kinds else 0
    noise = [synth_environment(rng, CLIP) for _ in range(n_noise - n_extra)]
    for _ in range(n_extra):
        kind = extra_kinds[int(rng.integers(len(extra_kinds)))]
        noise.append(synth_environment(rng, CLIP, kind))
    return speech.astype(np.float32), np.stack(noise).astype(np.float32)


def synth_field_recording(
    rng: np.random.Generator,
    seconds: float,
    sr: int = 32000,
    speech_events: Tuple[int, int] = (2, 8),
    snr_db: Tuple[float, float] = (0.0, 20.0),
) -> Tuple[np.ndarray, List[Tuple[float, float]]]:
    """A labeled outdoor recording at native rate ``sr``: an environment bed
    with speech utterances inserted at known times.

    Returns (audio float32 at ``sr``, [(start_s, end_s), ...] speech spans).
    A copy of the JAX package's ``train/synth.py::synth_field_recording``
    (bit-identical for a seed); ``train/evaluate.py`` scores detections
    against its labels.
    """
    n22 = int(seconds * SR)
    bed = synth_environment(rng, n22)
    second_kind = ENVIRONMENT_KINDS[rng.integers(len(ENVIRONMENT_KINDS))]
    bed = 0.7 * bed + 0.3 * synth_environment(rng, n22, second_kind)

    audio22 = 0.15 * bed
    # SNR reference is the environment bed ONLY: against the accumulating
    # mix, a later event overlapping an earlier one would see an inflated
    # "bed" RMS and come out louder than its labeled SNR
    bed_ref = audio22.copy()
    intervals: List[Tuple[float, float]] = []
    n_events = int(rng.integers(speech_events[0], speech_events[1] + 1))
    for _ in range(n_events):
        dur = float(rng.uniform(1.0, 6.0))
        # an event can't outlast a short recording (seconds < 6 crashed the
        # broadcast before this clamp)
        n = min(int(dur * SR), n22)
        sp, act = synth_speech(rng, n)
        if not act.any():
            continue
        at = int(rng.integers(0, max(1, n22 - n)))
        snr = float(rng.uniform(*snr_db))
        bed_rms = float(np.sqrt(np.mean(bed_ref[at : at + n] ** 2) + 1e-12))
        sp_rms = float(np.sqrt(np.mean(sp[act] ** 2) + 1e-12))
        gain = bed_rms * 10.0 ** (snr / 20.0) / sp_rms
        audio22[at : at + n] += gain * sp
        # activity runs → absolute intervals
        d = np.diff(act.astype(np.int8))
        starts = list(np.flatnonzero(d == 1) + 1)
        ends = list(np.flatnonzero(d == -1) + 1)
        if act[0]:
            starts = [0] + starts
        if act[-1]:
            ends = ends + [n]
        for s, e in zip(starts, ends):
            intervals.append(((at + s) / SR, (at + e) / SR))

    # merge label fragments closer than 0.3 s (sub-syllable gaps)
    merged = merge_intervals(intervals, gap=0.3)

    peak = np.abs(audio22).max()
    if peak > 0.99:
        audio22 = audio22 * (0.99 / peak)

    if sr == SR:
        return audio22.astype(np.float32), merged
    native = resample(audio22.astype(np.float32), SR, sr)
    return native.astype(np.float32), merged
