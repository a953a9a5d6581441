"""Acoustic degradations for robustness evaluation.

A copy of the JAX package's ``train/degrade.py``, sample for sample.
Applied to a finished (mixed) recording to probe how the trained detector
degrades under real-world capture conditions that neither synthetic
generator models directly:

  * ``rolloff4k``  — cheap-microphone high-frequency rolloff (2nd-order
    Butterworth lowpass at 4 kHz)
  * ``clip``       — input-stage hard clipping (gain into a ±1 limiter so a
    target fraction of samples saturate)
  * ``mulaw``      — 8-bit μ-law codec round trip (G.711-style)
  * ``hum``        — 50 Hz mains hum + harmonics at −25 dBFS
  * ``dropout``    — brief recorder dropouts (zeroed 20–80 ms gaps)
  * ``reverb03/08/15`` — room/forest reverberation at RT60 = 0.3/0.8/1.5 s
    (image-source early reflections + Schroeder exponential late tail —
    deliberately INDEPENDENT DSP from train/augment.py's log-spaced-tap
    reverb the model was trained on, so this measures transfer, not recall;
    ref voice_activity.py:734-788)
  * ``fading``     — slow-fading channel: a 8–20 s-period gain envelope on
    the recording plus a CONSTANT fresh noise floor, so the effective
    speech-to-noise ratio drifts slowly the way a moving source /
    wind-shadowed mic does (a time-varying condition)

Each function takes and returns float32 at the given sample rate; they are
deterministic given the rng.  Degradations compose: ``apply(audio, sr,
["rolloff4k", "mulaw"], rng)``.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np
from scipy import signal

DEGRADATIONS = ("rolloff4k", "clip", "mulaw", "hum", "dropout", "bfp4",
                "reverb03", "reverb08", "reverb15", "fading")


def rolloff4k(audio: np.ndarray, sr: int, rng: np.random.Generator) -> np.ndarray:
    # clamp the cutoff below Nyquist: at sr <= 8000 (telephone-band eval)
    # a 4 kHz Butterworth raises ValueError; a 0.45·sr rolloff is the
    # closest realizable mic-rolloff analogue there
    cutoff = min(4000.0, 0.45 * sr)
    sos = signal.butter(2, cutoff, btype="low", fs=sr, output="sos")
    return signal.sosfilt(sos, audio).astype(np.float32)


def clip(audio: np.ndarray, sr: int, rng: np.random.Generator,
         clip_fraction: float = 0.02) -> np.ndarray:
    """Gain so ~clip_fraction of samples exceed full scale, then hard clip."""
    mag = np.abs(audio)
    if not mag.any():
        return audio.astype(np.float32)
    thresh = np.quantile(mag, 1.0 - clip_fraction)
    if thresh <= 0:
        return audio.astype(np.float32)
    return np.clip(audio / thresh, -1.0, 1.0).astype(np.float32)


def mulaw(audio: np.ndarray, sr: int, rng: np.random.Generator) -> np.ndarray:
    """8-bit μ-law companding round trip — the JAX package's transport codec.

    Uses ops.mulaw's exact encode/decode (255-level mid-tread, code 0 ==
    digital silence) through the same int16 quantization a PCM16 file on
    disk would have, so the quality grid's "mulaw" condition exercises the
    codec the JAX fused engine puts on the wire (a 256-level mid-rise
    compander would map silence to a +8.6e-5 DC pedestal the real codec
    never produces).
    """
    from ..ops import mulaw as wire

    i16 = np.clip(np.rint(audio * 32768.0), -32768, 32767).astype(np.int16)
    return wire.decode_host(wire.encode_i16(i16))


def hum(audio: np.ndarray, sr: int, rng: np.random.Generator) -> np.ndarray:
    t = np.arange(len(audio)) / sr
    level = 10 ** (-25 / 20.0)
    h = np.zeros(len(audio))
    for k, g in ((1, 1.0), (2, 0.4), (3, 0.25)):
        h += g * np.sin(2 * np.pi * 50.0 * k * t + rng.uniform(0, 2 * np.pi))
    return (audio + level * h / 1.65).astype(np.float32)


def dropout(audio: np.ndarray, sr: int, rng: np.random.Generator,
            per_minute: float = 4.0) -> np.ndarray:
    out = audio.copy()
    n_gaps = max(1, int(len(audio) / sr / 60.0 * per_minute))
    for _ in range(n_gaps):
        g = int(rng.uniform(0.02, 0.08) * sr)
        at = int(rng.integers(0, max(1, len(audio) - g)))
        out[at: at + g] = 0.0
    return out.astype(np.float32)


def bfp4(audio: np.ndarray, sr: int, rng: np.random.Generator) -> np.ndarray:
    """4-bit block-floating-point round trip (ops/bfp4.py) — the JAX
    package's experimental half-of-mu-law wire, measured as a condition."""
    from ..ops import bfp4 as wire

    i16 = np.clip(np.rint(audio * 32768.0), -32768, 32767).astype(np.int16)
    return wire.roundtrip_i16(i16)


def _image_source_rir(sr: int, rt60: float,
                      rng: np.random.Generator) -> np.ndarray:
    """Shoebox room impulse response: Allen-Berkley image-source early
    reflections (order ≤ 2 per axis) crossfaded into a Schroeder
    exponentially-decaying Gaussian late tail.

    Wall reflectivity follows Sabine: alpha = 0.161 V / (S RT60), beta =
    sqrt(1 - alpha).  The tail's starting RMS continues the early part's
    measured envelope at the mixing time, and the whole RIR decays at
    exp(-6.91 t / RT60) so T60 is the parameter it claims to be.  This is
    NOT the training augmentation's reverb (log-spaced decaying taps,
    train/augment.py) — independent eval DSP by construction.
    """
    c = 343.0
    room = rng.uniform([4.0, 3.0, 2.5], [9.0, 7.0, 4.5]) * (1.0 + 0.5 * rt60)
    lo, hi = 0.5, room - 0.5
    src = rng.uniform(lo, hi)
    mic = rng.uniform(lo, hi)

    volume = float(np.prod(room))
    surface = 2.0 * (room[0] * room[1] + room[0] * room[2]
                     + room[1] * room[2])
    alpha = min(0.95, 0.161 * volume / (surface * rt60))
    beta = float(np.sqrt(1.0 - alpha))

    n_len = int(sr * (rt60 * 1.2 + 0.05))
    rir = np.zeros(n_len, np.float64)
    order = 2
    axes = []
    for dim in range(3):
        imgs = []
        for n in range(-order, order + 1):
            for p in (0, 1):
                coord = (1 - 2 * p) * src[dim] + 2.0 * n * room[dim]
                hits = abs(n - p) + abs(n)
                imgs.append((coord - mic[dim], hits))
        axes.append(imgs)
    d0 = float(np.linalg.norm(src - mic))
    # delays are relative to the DIRECT path (all image paths are longer),
    # so the wet signal stays time-aligned with the truth labels
    for dx, hx in axes[0]:
        for dy, hy in axes[1]:
            for dz, hz in axes[2]:
                d = float(np.sqrt(dx * dx + dy * dy + dz * dz))
                at = (d - d0) / c * sr
                idx = int(at)
                if idx + 1 >= n_len:
                    continue
                amp = beta ** (hx + hy + hz) / max(d, 0.3)
                frac = at - idx  # linear-interp fractional delay
                rir[idx] += amp * (1.0 - frac)
                rir[idx + 1] += amp * frac

    # Schroeder tail from the mixing time onward, RMS-matched to the early
    # part's envelope there, decaying at the same T60
    t_mix = 0.05  # after the (t=0) direct arrival
    i_mix = min(n_len - 1, int(t_mix * sr))
    win = rir[max(0, i_mix - int(0.01 * sr)): i_mix + 1]
    env_rms = float(np.sqrt(np.mean(win ** 2))) if len(win) else 1e-4
    t = np.arange(n_len - i_mix) / sr
    tail = rng.standard_normal(n_len - i_mix) * env_rms * np.exp(
        -6.907755 * t / rt60)
    # crossfade 10 ms so the splice is inaudible
    xf = min(int(0.01 * sr), len(tail))
    ramp = np.linspace(0.0, 1.0, xf, endpoint=False)
    rir[i_mix: i_mix + xf] = (rir[i_mix: i_mix + xf] * (1 - ramp)
                              + tail[:xf] * ramp)
    rir[i_mix + xf:] = tail[xf:]
    # unit direct-path amplitude: keeps speech level comparable pre/post
    return (rir / max(1.0 / max(d0, 0.3), 1e-9)).astype(np.float64)


def _reverb(audio: np.ndarray, sr: int, rng: np.random.Generator,
            rt60: float) -> np.ndarray:
    rir = _image_source_rir(sr, rt60, rng)
    wet = signal.oaconvolve(audio.astype(np.float64), rir)[: len(audio)]
    return wet.astype(np.float32)


def reverb03(audio, sr, rng):
    return _reverb(audio, sr, rng, 0.3)


def reverb08(audio, sr, rng):
    return _reverb(audio, sr, rng, 0.8)


def reverb15(audio, sr, rng):
    return _reverb(audio, sr, rng, 1.5)


def fading(audio: np.ndarray, sr: int, rng: np.random.Generator) -> np.ndarray:
    """Slow-fading channel: gain envelope (8–20 s period random walk mapped
    to a −24..0 dB track, i.e. linear 0.063–1) times the recording, plus a
    constant −32 dBFS lowpassed noise floor.  The envelope scales signal AND its recorded background
    together while the added floor stays fixed, so the effective SNR drifts
    slowly — the moving-source / wind-shadow case the static snr conditions
    cannot represent."""
    n = len(audio)
    period = float(rng.uniform(8.0, 20.0))
    n_knots = max(4, int(n / sr / period) + 2)
    # random walk normalized to unit spread, then mapped to a gain track
    # in dB: mean −9 dB, ±9 dB/σ, clamped to [−24, 0] so the deepest fade
    # still leaves speech present (a 24 dB swing is a source walking a few
    # hundred meters in open terrain)
    walk = np.cumsum(rng.standard_normal(n_knots))
    walk = (walk - walk.mean()) / max(float(walk.std()), 1e-9)
    x_knots = np.linspace(0, n - 1, n_knots)
    env_db = np.clip(-9.0 + 9.0 * np.interp(np.arange(n), x_knots, walk),
                     -24.0, 0.0)
    env = 10.0 ** (env_db / 20.0)
    floor = rng.standard_normal(n)
    sos = signal.butter(1, min(3000.0, 0.4 * sr), btype="low", fs=sr,
                        output="sos")
    floor = signal.sosfilt(sos, floor)
    floor *= 10 ** (-32 / 20.0) / max(float(np.sqrt(np.mean(floor ** 2))),
                                      1e-12)
    return (audio * env + floor).astype(np.float32)


_FNS = {
    "rolloff4k": rolloff4k, "clip": clip, "mulaw": mulaw,
    "hum": hum, "dropout": dropout, "bfp4": bfp4,
    "reverb03": reverb03, "reverb08": reverb08, "reverb15": reverb15,
    "fading": fading,
}


def apply(audio: np.ndarray, sr: int, kinds: Iterable[str],
          rng: np.random.Generator) -> np.ndarray:
    out = np.asarray(audio, np.float32)
    for kind in kinds:
        out = _FNS[kind](out, sr, rng)
    peak = float(np.abs(out).max())
    if peak > 0.99:
        out = out * (0.99 / peak)
    return out
