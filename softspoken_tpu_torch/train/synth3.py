"""Third training-texture family (TRAIN-ONLY confusers; VERDICT r3 #7).

The round-2/3 out-of-family evals showed the detector overfits the
*implementation* of its training textures: the independently-written v2
generator exposed false fires on texture classes v1 never produced.  v2
stays strictly eval-only, so this module attacks generator overfit from
the training side instead: a third family of noise/confuser textures
whose DSP shares nothing with either ``train/synth.py`` (filtered-noise /
FM-chirp / excitation-resonator methods) or ``train/synth2.py`` (LF
glottal + cascade formants + OU fields):

  * ``granular``     — granular synthesis: clouds of short windowed grains
    cut from a per-clip stochastic wavetable, scattered with random pitch
    (resampled grain playback), density ramps, and stereo-ish comb
    coloration.  Covers machinery churn / insect-swarm / gravel textures.
  * ``drone``        — wavetable drone: a random single-cycle harmonic
    wavetable looped at a low fundamental with slow detune beating between
    2-3 voices and an LFO-swept one-pole tilt.  Covers engines, fans,
    distant aircraft — sustained pitched non-speech.
  * ``impact_chain`` — modal impacts: sparse sequences of strikes, each a
    sum of 3-6 exponentially-damped sinusoid modes from a random modal
    body, band-shaped click excitation.  Covers knocks, footsteps, stone
    clacks, equipment handling — the impulsive class.
  * ``crackle``      — Poisson crackle: a shot-noise point process (random
    sign and amplitude heavy-tailed pops) through a short random FIR body,
    with burst-density modulation.  Covers fire crackle, twig snaps,
    electrostatic interference.

The reference's analogue is dataset diversity (PeoplesSpeech x ESC-50,
``voice_activity.py:257-297``); with no downloadable data in this
environment, diversity has to come from independent synthesis methods.

Usage: these kinds register as opt-in extras for the training noise pool
(``synth.make_pools(extra_kinds=...)``, CLI ``train --noise-extra``);
they are never used by any eval set, so grid scores keep measuring
transfer, not recall.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy import signal

SR = 22050

KINDS3 = ("granular", "drone", "impact_chain", "crackle")


def _smooth_env(rng: np.random.Generator, n: int, knots: int,
                lo: float, hi: float) -> np.ndarray:
    """Random smooth envelope in [lo, hi] via cosine-interpolated knots."""
    k = np.clip(rng.uniform(lo, hi, max(2, knots)), lo, hi)
    x = np.linspace(0.0, 1.0, len(k))
    xi = np.linspace(0.0, 1.0, n)
    # cosine interpolation: C1-ish smoothness without scipy splines
    idx = np.clip(np.searchsorted(x, xi, side="right") - 1, 0, len(k) - 2)
    t = (xi - x[idx]) / (x[idx + 1] - x[idx])
    t = 0.5 - 0.5 * np.cos(np.pi * t)
    return (k[idx] * (1 - t) + k[idx + 1] * t).astype(np.float32)


def _granular(rng: np.random.Generator, n: int) -> np.ndarray:
    # a stochastic wavetable: a short noise snippet shaped by a random
    # spectral tilt, from which all grains are cut
    table = rng.standard_normal(int(0.25 * SR)).astype(np.float32)
    tilt = signal.butter(1, float(rng.uniform(500, 6000)), btype="low",
                         fs=SR, output="sos")
    table = signal.sosfilt(tilt, table).astype(np.float32)

    out = np.zeros(n, np.float32)
    density = _smooth_env(rng, n, 6, 0.2, 1.0)  # grains/s modulation
    base_rate = float(rng.uniform(30, 250))  # grains per second
    n_grains = max(1, int(n / SR * base_rate))
    starts = rng.integers(0, n, n_grains)
    keep = rng.uniform(0, 1, n_grains) < density[np.minimum(starts, n - 1)]
    for at in starts[keep]:
        glen = int(rng.uniform(0.005, 0.06) * SR)
        speed = float(2.0 ** rng.uniform(-1.0, 1.0))  # +-1 octave repitch
        src_len = max(4, int(glen * speed))
        s0 = int(rng.integers(0, max(1, len(table) - src_len)))
        grain = np.interp(np.linspace(0, src_len - 1, glen),
                          np.arange(src_len), table[s0:s0 + src_len])
        grain = grain * np.hanning(glen)
        end = min(n, at + glen)
        out[at:end] += (rng.uniform(0.2, 1.0)
                        * grain[: end - at]).astype(np.float32)
    # comb coloration (a short self-delay) gives the cloud a body resonance
    d = int(rng.uniform(0.002, 0.012) * SR)
    if d > 0 and d < n:
        out[d:] += 0.4 * out[:-d]
    return out


def _drone(rng: np.random.Generator, n: int) -> np.ndarray:
    # random single-cycle harmonic wavetable, 2048 samples
    nh = int(rng.integers(3, 16))
    amps = (rng.uniform(0.2, 1.0, nh) / np.arange(1, nh + 1)
            ** rng.uniform(0.5, 1.5))
    phases = rng.uniform(0, 2 * np.pi, nh)
    cyc = np.arange(2048) / 2048.0
    table = np.zeros(2048)
    for k in range(nh):
        table += amps[k] * np.sin(2 * np.pi * (k + 1) * cyc + phases[k])
    table /= max(1e-9, np.abs(table).max())

    f0 = float(rng.uniform(35.0, 160.0))  # engine/fan register
    out = np.zeros(n)
    t = np.arange(n)
    for _voice in range(int(rng.integers(2, 4))):
        detune = 1.0 + rng.uniform(-0.008, 0.008)
        # slow frequency wobble (load changes)
        wob = 1.0 + 0.01 * np.interp(
            np.linspace(0, 1, n), np.linspace(0, 1, 16),
            rng.standard_normal(16).cumsum() * 0.2)
        phase = np.cumsum(f0 * detune * wob) / SR * 2048.0
        out += rng.uniform(0.5, 1.0) * np.interp(
            phase % 2048.0, np.arange(2048), table)
    # LFO-swept one-pole spectral tilt: y[i] = (1-a)x[i] + a y[i-1] with a
    # slowly varying — cheap moving formant
    a = _smooth_env(rng, n, 8, 0.5, 0.97).astype(np.float64)
    y = np.empty(n)
    acc = 0.0
    # vectorize the varying one-pole as blocks of constant coefficient
    B = 2048
    for b0 in range(0, n, B):
        b1 = min(n, b0 + B)
        ab = float(a[b0])
        seg = signal.lfilter([1 - ab], [1, -ab], out[b0:b1], zi=[acc * ab])
        y[b0:b1], acc = seg[0], seg[0][-1]
    return y.astype(np.float32)


def _impact_chain(rng: np.random.Generator, n: int) -> np.ndarray:
    # one random modal body per clip (a struck object has fixed modes)
    n_modes = int(rng.integers(3, 7))
    freqs = np.sort(rng.uniform(120.0, 5000.0, n_modes))
    decays = rng.uniform(20.0, 200.0, n_modes)  # 1/s
    gains = rng.uniform(0.3, 1.0, n_modes) / np.arange(1, n_modes + 1)

    ir_len = int(0.25 * SR)
    t = np.arange(ir_len) / SR
    ir = np.zeros(ir_len)
    for f, d, g in zip(freqs, decays, gains):
        ir += g * np.exp(-d * t) * np.sin(2 * np.pi * f * t)
    ir /= max(1e-9, np.abs(ir).max())

    rate = float(rng.uniform(0.5, 6.0))  # strikes per second, NOT periodic
    n_hits = max(1, int(n / SR * rate))
    exc = np.zeros(n, np.float32)
    at = np.sort(rng.integers(0, n, n_hits))
    for a0 in at:
        # a strike is a 1-3 ms band-shaped click, not a delta
        clen = int(rng.uniform(0.001, 0.003) * SR)
        click = rng.standard_normal(max(2, clen)) * np.hanning(max(2, clen))
        end = min(n, a0 + len(click))
        exc[a0:end] += (rng.uniform(0.3, 1.0)
                        * click[: end - a0]).astype(np.float32)
    return signal.fftconvolve(exc, ir)[:n].astype(np.float32)


def _crackle(rng: np.random.Generator, n: int) -> np.ndarray:
    # shot noise: Poisson pops with heavy-tailed amplitudes (Pareto),
    # random sign, density modulated by a slow burst envelope
    density = _smooth_env(rng, n, 10, 0.05, 1.0)
    base_rate = float(rng.uniform(100, 1200))  # pops per second
    n_pops = max(1, int(n / SR * base_rate))
    at = rng.integers(0, n, n_pops)
    keep = rng.uniform(0, 1, n_pops) < density[np.minimum(at, n - 1)]
    at = at[keep]
    amps = (rng.pareto(2.5, len(at)) + 0.2) * rng.choice((-1.0, 1.0), len(at))
    exc = np.zeros(n, np.float32)
    np.add.at(exc, at, amps.astype(np.float32))
    # short random FIR body (8-40 taps) colors the pops
    body = rng.standard_normal(int(rng.integers(8, 40))).astype(np.float32)
    body *= np.exp(-np.arange(len(body)) / rng.uniform(2.0, 10.0)).astype(
        np.float32)
    out = signal.fftconvolve(exc, body)[:n].astype(np.float32)
    return out


_FNS3 = {"granular": _granular, "drone": _drone,
         "impact_chain": _impact_chain, "crackle": _crackle}


def texture3(rng: np.random.Generator, n_samples: int,
             kind: Optional[str] = None) -> np.ndarray:
    """One clip of the third-family texture ``kind`` (random if None),
    peak-normalized to <= 0.9 like the other generators' outputs."""
    if kind is None:
        kind = KINDS3[int(rng.integers(len(KINDS3)))]
    out = _FNS3[kind](rng, int(n_samples))
    peak = float(np.abs(out).max())
    if peak > 0:
        out = out * (0.9 / peak)
    return out.astype(np.float32)
