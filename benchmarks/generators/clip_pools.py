"""Seeded training clip pools: 3 s formant speech and 3 s environment clips.

The round-5 recipe's pools as the port's ``train/synth.py::make_pools``
lays them out: ``speech`` (n_speech, 66150) and ``noise`` (n_noise, 66150)
float32 at 22,050 Hz, the last ``extra_frac`` of the noise pool drawn from
the opt-in confuser kinds.  The speech and the eight default environment
kinds are ``field_recordings.py``'s frozen copies; the third-family
confusers (granular, drone, impact_chain, crackle) are frozen copies of the
port's ``train/synth3.py``.  Each clip has its own seed (the run's seed and
its index), so the pools do not depend on how many worker processes make
them.

Parameters (a ``traffic/<name>.json`` file): ``n_speech``, ``n_noise``,
``extra_kinds``, ``extra_frac``, ``workers`` (processes that synthesize).
"""

from __future__ import annotations

import importlib.util
import os
from typing import Dict, List, Tuple

import numpy as np
from scipy import signal

SR = 22050
CLIP = 3 * SR

_HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "_bench_generators_field_recordings_for_pools", os.path.join(_HERE, "field_recordings.py"))
F = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(F)


# --------------------------------------------------------------------------
# third-family confusers (synth3.py at 22,050 Hz)
# --------------------------------------------------------------------------

def _smooth_env(rng, n: int, knots: int, lo: float, hi: float) -> np.ndarray:
    k = np.clip(rng.uniform(lo, hi, max(2, knots)), lo, hi)
    x = np.linspace(0.0, 1.0, len(k))
    xi = np.linspace(0.0, 1.0, n)
    idx = np.clip(np.searchsorted(x, xi, side="right") - 1, 0, len(k) - 2)
    t = (xi - x[idx]) / (x[idx + 1] - x[idx])
    t = 0.5 - 0.5 * np.cos(np.pi * t)
    return (k[idx] * (1 - t) + k[idx + 1] * t).astype(np.float32)


def _granular(rng, n: int) -> np.ndarray:
    table = rng.standard_normal(int(0.25 * SR)).astype(np.float32)
    tilt = signal.butter(1, float(rng.uniform(500, 6000)), btype="low", fs=SR, output="sos")
    table = signal.sosfilt(tilt, table).astype(np.float32)
    out = np.zeros(n, np.float32)
    density = _smooth_env(rng, n, 6, 0.2, 1.0)
    base_rate = float(rng.uniform(30, 250))
    n_grains = max(1, int(n / SR * base_rate))
    starts = rng.integers(0, n, n_grains)
    keep = rng.uniform(0, 1, n_grains) < density[np.minimum(starts, n - 1)]
    for at in starts[keep]:
        glen = int(rng.uniform(0.005, 0.06) * SR)
        speed = float(2.0 ** rng.uniform(-1.0, 1.0))
        src_len = max(4, int(glen * speed))
        s0 = int(rng.integers(0, max(1, len(table) - src_len)))
        grain = np.interp(np.linspace(0, src_len - 1, glen), np.arange(src_len),
                          table[s0:s0 + src_len]) * np.hanning(glen)
        end = min(n, at + glen)
        out[at:end] += (rng.uniform(0.2, 1.0) * grain[: end - at]).astype(np.float32)
    d = int(rng.uniform(0.002, 0.012) * SR)
    if 0 < d < n:
        out[d:] += 0.4 * out[:-d]
    return out


def _drone(rng, n: int) -> np.ndarray:
    nh = int(rng.integers(3, 16))
    amps = rng.uniform(0.2, 1.0, nh) / np.arange(1, nh + 1) ** rng.uniform(0.5, 1.5)
    phases = rng.uniform(0, 2 * np.pi, nh)
    cyc = np.arange(2048) / 2048.0
    table = np.zeros(2048)
    for k in range(nh):
        table += amps[k] * np.sin(2 * np.pi * (k + 1) * cyc + phases[k])
    table /= max(1e-9, np.abs(table).max())
    f0 = float(rng.uniform(35.0, 160.0))
    out = np.zeros(n)
    for _ in range(int(rng.integers(2, 4))):
        detune = 1.0 + rng.uniform(-0.008, 0.008)
        wob = 1.0 + 0.01 * np.interp(np.linspace(0, 1, n), np.linspace(0, 1, 16),
                                     rng.standard_normal(16).cumsum() * 0.2)
        phase = np.cumsum(f0 * detune * wob) / SR * 2048.0
        out += rng.uniform(0.5, 1.0) * np.interp(phase % 2048.0, np.arange(2048), table)
    a = _smooth_env(rng, n, 8, 0.5, 0.97).astype(np.float64)
    y = np.empty(n)
    acc = 0.0
    for b0 in range(0, n, 2048):
        b1 = min(n, b0 + 2048)
        ab = float(a[b0])
        seg = signal.lfilter([1 - ab], [1, -ab], out[b0:b1], zi=[acc * ab])
        y[b0:b1], acc = seg[0], seg[0][-1]
    return y.astype(np.float32)


def _impact_chain(rng, n: int) -> np.ndarray:
    n_modes = int(rng.integers(3, 7))
    freqs = np.sort(rng.uniform(120.0, 5000.0, n_modes))
    decays = rng.uniform(20.0, 200.0, n_modes)
    gains = rng.uniform(0.3, 1.0, n_modes) / np.arange(1, n_modes + 1)
    t = np.arange(int(0.25 * SR)) / SR
    ir = np.zeros(len(t))
    for f, d, g in zip(freqs, decays, gains):
        ir += g * np.exp(-d * t) * np.sin(2 * np.pi * f * t)
    ir /= max(1e-9, np.abs(ir).max())
    rate = float(rng.uniform(0.5, 6.0))
    exc = np.zeros(n, np.float32)
    for a0 in np.sort(rng.integers(0, n, max(1, int(n / SR * rate)))):
        clen = int(rng.uniform(0.001, 0.003) * SR)
        click = rng.standard_normal(max(2, clen)) * np.hanning(max(2, clen))
        end = min(n, a0 + len(click))
        exc[a0:end] += (rng.uniform(0.3, 1.0) * click[: end - a0]).astype(np.float32)
    return signal.fftconvolve(exc, ir)[:n].astype(np.float32)


def _crackle(rng, n: int) -> np.ndarray:
    density = _smooth_env(rng, n, 10, 0.05, 1.0)
    base_rate = float(rng.uniform(100, 1200))
    n_pops = max(1, int(n / SR * base_rate))
    at = rng.integers(0, n, n_pops)
    at = at[rng.uniform(0, 1, n_pops) < density[np.minimum(at, n - 1)]]
    amps = (rng.pareto(2.5, len(at)) + 0.2) * rng.choice((-1.0, 1.0), len(at))
    exc = np.zeros(n, np.float32)
    np.add.at(exc, at, amps.astype(np.float32))
    body = rng.standard_normal(int(rng.integers(8, 40))).astype(np.float32)
    body *= np.exp(-np.arange(len(body)) / rng.uniform(2.0, 10.0)).astype(np.float32)
    return signal.fftconvolve(exc, body)[:n].astype(np.float32)


THIRD = {"granular": _granular, "drone": _drone, "impact_chain": _impact_chain,
         "crackle": _crackle}


def _clip(kind: str, seed: int, index: int) -> np.ndarray:
    rng = np.random.default_rng([seed, index])
    if kind == "speech":
        return F.synth_speech(rng, CLIP, SR)[0]
    if kind == "noise":
        return F.synth_environment(rng, CLIP, F.KINDS[int(rng.integers(len(F.KINDS)))], SR)
    out = THIRD[kind](rng, CLIP)
    peak = float(np.abs(out).max())
    return (out * (0.9 / peak)).astype(np.float32) if peak > 0 else out


def clips(jobs: List[Tuple[str, int, int]]) -> np.ndarray:
    return np.stack([_clip(*j) for j in jobs]).astype(np.float32)


def generate(params: Dict, seed: int, out_dir: str = "") -> Dict[str, np.ndarray]:
    """{"speech": (n_speech, 66150), "noise": (n_noise, 66150)} float32."""
    from benchmarks.harness import procpool

    s = int(seed) & (2**63 - 1)
    rng = np.random.default_rng([s, 0x706F6F6C])
    n_sp, n_nz = int(params["n_speech"]), int(params["n_noise"])
    extra = list(params.get("extra_kinds", ()))
    n_extra = int(n_nz * float(params.get("extra_frac", 0.0))) if extra else 0
    kinds = ["speech"] * n_sp + ["noise"] * (n_nz - n_extra) + [
        extra[int(rng.integers(len(extra)))] for _ in range(n_extra)]
    jobs = [(k, s, i) for i, k in enumerate(kinds)]
    workers = max(1, min(int(params.get("workers", 1)), os.cpu_count() or 1))
    per = -(-len(jobs) // (4 * workers))
    parts = procpool.map_calls(os.path.abspath(__file__), "clips",
                               [(jobs[i: i + per],) for i in range(0, len(jobs), per)],
                               workers)
    allc = np.concatenate(parts)
    return {"speech": allc[:n_sp], "noise": allc[n_sp:]}
