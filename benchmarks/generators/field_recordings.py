"""Seeded field recordings: an ambient bed with speech events, PCM16 WAV.

A frozen numpy copy of the port's ``train/synth.py`` generators
(``synth_speech``, ``synth_environment`` over its eight default kinds,
and the SNR rule of ``synth_field_recording``), rendered at the file's own
sample rate instead of 22,050 Hz.  The program receives only the files.

Parameters (a ``traffic/<name>.json`` file):

    files               distinct recordings
    seconds             length of each
    sample_rate         native rate of the WAV (PCM16 mono)
    speech_share        share of each file covered by speech events
    event_seconds       [lo, hi]: length of one speech event; a file holds
                        round(share x seconds / their mean) events, their
                        drawn lengths scaled to cover the share exactly
    snr_db              [lo, hi]: event level over the bed under it
    bed_tile_seconds    the bed is built of tiles of this length, drawn from
                        a bank of ``bed_bank`` tiles (two kinds mixed 0.7/0.3
                        as synth_field_recording does), each placed with its
                        own gain and a 50 ms crossfade
    workers             processes that write the files (each file has its
                        own seed, so the files do not depend on it)

Every seed gives the same sizes: the same number of files of the same
length, each with the same number of speech events covering the same
share; only the content, the events' lengths and their times differ.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
from scipy import signal

KINDS = ("wind", "rain", "stream", "birds", "insects", "rumble", "calls", "hum")

_VOWELS = np.array(
    [[730, 1090, 2440], [270, 2290, 3010], [300, 870, 2240], [530, 1840, 2480],
     [570, 840, 2410], [440, 1020, 2240], [660, 1720, 2410], [490, 1350, 1690]],
    np.float64,
)


# --------------------------------------------------------------------------
# speech (synth.py::synth_speech at rate sr)
# --------------------------------------------------------------------------

def _resonator(x: np.ndarray, freq: float, bw: float, sr: int) -> np.ndarray:
    r = np.exp(-np.pi * bw / sr)
    w = 2.0 * np.pi * freq / sr
    a = [1.0, -2.0 * r * np.cos(w), r * r]
    b = [(1.0 - r) * np.sqrt(1.0 - 2.0 * r * np.cos(2.0 * w) + r * r)]
    return signal.lfilter(b, a, x)


def _glottal_pulses(n: int, f0: np.ndarray, rng: np.random.Generator, sr: int) -> np.ndarray:
    phase = np.cumsum(f0) / sr
    pulses = np.zeros(n, np.float32)
    idx = np.searchsorted(phase, np.arange(1, int(phase[-1]) + 1))
    idx = idx[idx < n]
    pulses[idx] = 1.0 + 0.15 * rng.standard_normal(len(idx))
    return pulses


def synth_speech(rng: np.random.Generator, n: int, sr: int) -> Tuple[np.ndarray, np.ndarray]:
    """Formant speech of ``n`` samples at ``sr``: (audio, activity)."""
    audio = np.zeros(n, np.float32)
    active = np.zeros(n, bool)
    f0_base = float(rng.uniform(85.0, 255.0))
    vt_scale = float(rng.uniform(0.85, 1.15))
    breathiness = float(rng.uniform(0.01, 0.08))
    fric_sos = signal.butter(2, [3000, sr // 2 - 500], btype="band", fs=sr, output="sos")

    pos = int(rng.integers(0, sr // 4))
    while pos < n - sr // 10:
        n_syll = int(rng.integers(1, 9))
        declination = 1.0
        for _ in range(n_syll):
            if pos >= n - sr // 20:
                break
            syl_len = min(int(rng.uniform(0.08, 0.32) * sr), n - pos)
            seg = np.zeros(syl_len, np.float32)
            fric_len = 0
            if rng.uniform() < 0.3 and syl_len > int(0.06 * sr):
                fric_len = min(int(rng.uniform(0.03, 0.08) * sr), syl_len // 2)
                fric = signal.sosfilt(fric_sos, rng.standard_normal(fric_len)).astype(np.float32)
                fric *= np.hanning(fric_len).astype(np.float32)
                seg[:fric_len] = 0.35 * fric / (np.abs(fric).max() + 1e-9)
            v_len = syl_len - fric_len
            if v_len > 64:
                f0 = f0_base * declination * (
                    1.0
                    + 0.12 * np.sin(np.linspace(0, np.pi, v_len) * rng.uniform(0.5, 2.0))
                    + 0.02 * rng.standard_normal(v_len).cumsum() / np.sqrt(np.arange(1, v_len + 1)))
                src = _glottal_pulses(v_len, np.clip(f0, 60.0, 400.0), rng, sr)
                src = signal.lfilter([1.0], [1.0, -0.96], src).astype(np.float32)
                src += breathiness * rng.standard_normal(v_len).astype(np.float32)
                vowel = _VOWELS[rng.integers(len(_VOWELS))] * vt_scale * rng.uniform(0.92, 1.08, 3)
                y = np.zeros(v_len)
                for fmt, bw, g in zip(vowel, (60.0, 90.0, 140.0), (1.0, 0.63, 0.3)):
                    y = y + g * _resonator(src, float(fmt), bw, sr)
                y = np.diff(y, prepend=0.0)
                env = np.ones(v_len)
                a = min(v_len // 2, max(8, int(0.012 * sr)))
                env[:a] = np.linspace(0, 1, a)
                d = min(v_len // 2, max(8, int(rng.uniform(0.01, 0.05) * sr)))
                env[-d:] *= np.linspace(1, 0, d)
                seg[fric_len:] = (y * env / (np.abs(y).max() + 1e-9)).astype(np.float32)
            audio[pos: pos + syl_len] += float(rng.uniform(0.5, 1.0)) * seg
            active[pos: pos + syl_len] = True
            pos += syl_len
            declination *= rng.uniform(0.95, 1.0)
            if rng.uniform() < 0.4:
                pos += int(rng.uniform(0.01, 0.06) * sr)
        pos += int(rng.uniform(0.15, 1.2) * sr)
    peak = np.abs(audio).max()
    if peak > 0:
        audio /= peak
    return audio, active


# --------------------------------------------------------------------------
# environment (synth.py::synth_environment at rate sr)
# --------------------------------------------------------------------------

def _colored_noise(rng, n: int, alpha: float, sr: int) -> np.ndarray:
    spec = np.fft.rfft(rng.standard_normal(n))
    f = np.maximum(np.fft.rfftfreq(n, 1.0 / sr), 1.0)
    out = np.fft.irfft(spec / f ** (alpha / 2.0), n)
    return (out / (np.abs(out).max() + 1e-12)).astype(np.float32)


def synth_environment(rng: np.random.Generator, n: int, kind: str, sr: int) -> np.ndarray:
    if kind == "wind":
        base = _colored_noise(rng, n, 2.0, sr)
        gust = _colored_noise(rng, max(64, n // 256), 1.0, sr)
        am = 0.55 + 0.45 * np.interp(np.linspace(0, 1, n), np.linspace(0, 1, len(gust)), gust)
        out = base * am.astype(np.float32)
    elif kind == "rain":
        hiss = 0.25 * _colored_noise(rng, n, 0.5, sr)
        drops = np.zeros(n, np.float32)
        n_drops = int(n / sr * rng.uniform(40, 400))
        at = rng.integers(0, n, n_drops)
        drops[at] = rng.uniform(0.2, 1.0, n_drops).astype(np.float32)
        decay = np.exp(-np.arange(64) / rng.uniform(4, 16)).astype(np.float32)
        out = hiss + signal.fftconvolve(drops, decay)[:n]
    elif kind == "stream":
        sos = signal.butter(2, [400, 4000], btype="band", fs=sr, output="sos")
        out = signal.sosfilt(sos, rng.standard_normal(n)).astype(np.float32)
        warble = 1.0 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.3, 2.0) * np.arange(n) / sr)
        out = out * warble.astype(np.float32)
    elif kind == "birds":
        out = np.zeros(n, np.float32)
        t_all = np.arange(n) / sr
        for _ in range(max(1, int(n / sr * rng.uniform(0.5, 4.0)))):
            dur = min(int(rng.uniform(0.05, 0.4) * sr), n)
            at = int(rng.integers(0, max(1, n - dur)))
            f_lo = rng.uniform(1800, 5000)
            f_hi = f_lo * rng.uniform(1.1, 2.2)
            tt = t_all[:dur]
            f = np.linspace(f_lo, f_hi, dur) * (1 + 0.05 * np.sin(2 * np.pi * rng.uniform(10, 40) * tt))
            chirp = np.sin(2 * np.pi * np.cumsum(f) / sr) * np.hanning(dur)
            out[at: at + dur] += rng.uniform(0.3, 1.0) * chirp.astype(np.float32)
    elif kind == "insects":
        t = np.arange(n) / sr
        f_c = rng.uniform(3500, 7000)
        am = 0.5 * (1 + signal.square(2 * np.pi * rng.uniform(5, 30) * t, duty=0.5))
        out = (np.sin(2 * np.pi * f_c * t) * am).astype(np.float32)
        out += 0.05 * _colored_noise(rng, n, 1.0, sr)
    elif kind == "rumble":
        sos = signal.butter(4, 150, btype="low", fs=sr, output="sos")
        bursts = _colored_noise(rng, n, 1.5, sr)
        env = np.clip(_colored_noise(rng, max(64, n // 512), 1.0, sr), 0, None)
        am = np.interp(np.linspace(0, 1, n), np.linspace(0, 1, len(env)), env)
        out = signal.sosfilt(sos, bursts).astype(np.float32) * (0.3 + am).astype(np.float32)
    elif kind == "calls":
        out = np.zeros(n, np.float32)
        for _ in range(max(1, int(n / sr * rng.uniform(0.3, 2.0)))):
            dur = min(int(rng.uniform(0.1, 0.6) * sr), n)
            at = int(rng.integers(0, max(1, n - dur)))
            f0 = float(rng.uniform(300.0, 1300.0))
            sweep = 1.0 + rng.uniform(-0.25, 0.25) * np.linspace(0, 1, dur)
            src = _glottal_pulses(dur, np.clip(f0 * sweep, 200.0, 2000.0), rng, sr)
            y = np.zeros(dur)
            for fc, bw, g in ((rng.uniform(800, 1800), 250.0, 1.0),
                              (rng.uniform(2000, 3500), 400.0, 0.5)):
                y = y + g * _resonator(src, float(fc), bw, sr)
            rough = 1.0 + 0.5 * np.sin(2 * np.pi * rng.uniform(40, 120) * np.arange(dur) / sr)
            y = y * rough * signal.windows.tukey(dur, 0.5)
            peak = np.abs(y).max()
            if peak > 0:
                out[at: at + dur] += (rng.uniform(0.4, 1.0) * y / peak).astype(np.float32)
    elif kind == "hum":
        t = np.arange(n) / sr
        f_base = float(rng.choice((50.0, 60.0)))
        drift = 1.0 + 1e-3 * np.interp(np.linspace(0, 1, n), np.linspace(0, 1, 64),
                                       rng.standard_normal(64).cumsum() * 0.1)
        phase = 2 * np.pi * np.cumsum(f_base * drift) / sr
        out = np.zeros(n)
        for k in (1, 3, 5, 7, 9, 11):
            out += rng.uniform(0.5, 1.0) / k * np.sin(k * phase + rng.uniform(0, 2 * np.pi))
        wobble = 1.0 + 0.25 * np.sin(2 * np.pi * rng.uniform(0.05, 0.5) * t
                                     + rng.uniform(0, 2 * np.pi))
        out = (out * wobble).astype(np.float32)
        out += 0.03 * _colored_noise(rng, n, 1.0, sr)
    else:
        raise ValueError(f"unknown environment kind {kind!r}")
    peak = np.abs(out).max()
    return (out / peak).astype(np.float32) if peak > 0 else out.astype(np.float32)


# --------------------------------------------------------------------------
# recordings
# --------------------------------------------------------------------------

def _bed(rng, bank: List[np.ndarray], n: int, tile: int, sr: int) -> np.ndarray:
    """``n`` samples of bed: tiles from ``bank`` in seeded order, each at its
    own gain, joined by 50 ms linear crossfades."""
    fade = int(0.05 * sr)
    out = np.zeros(n + tile, np.float32)
    ramp = np.linspace(0.0, 1.0, fade, dtype=np.float32)
    at = 0
    while at < n:
        t = bank[int(rng.integers(len(bank)))] * np.float32(rng.uniform(0.5, 1.0))
        t = t.copy()
        if at > 0:
            t[:fade] *= ramp
        t[-fade:] *= ramp[::-1]
        out[at: at + tile] += t
        at += tile - fade
    return out[:n]


def _speech_events(rng, n: int, sr: int, share: float, ev: Tuple[float, float]):
    """Non-overlapping (start, length) events covering ``share`` of ``n``:
    round(share * n / mean length) events, their lengths drawn in ``ev``
    and scaled to the share, the gaps between them drawn."""
    total = share * n
    count = max(1, int(round(total / (0.5 * (ev[0] + ev[1]) * sr))))
    lens = rng.uniform(ev[0], ev[1], count) * sr
    lens = (lens * (total / lens.sum())).astype(np.int64)
    gaps = rng.dirichlet(np.ones(count + 1)) * max(0, n - int(lens.sum()))
    out, at = [], 0.0
    for g, ln in zip(gaps, lens):
        at += g
        out.append((int(at), int(ln)))
        at += ln
    return out


def make_recording(rng: np.random.Generator, bank: List[np.ndarray], p: dict) -> np.ndarray:
    """One recording as int16 samples."""
    sr = int(p["sample_rate"])
    n = int(round(p["seconds"] * sr))
    bed = 0.15 * _bed(rng, bank, n, len(bank[0]), sr)
    bed_ref = bed.copy()
    audio = bed
    for at, ln in _speech_events(rng, n, sr, float(p["speech_share"]),
                                 tuple(p["event_seconds"])):
        ln = min(ln, n - at)
        if ln <= sr // 10:
            continue
        sp, act = synth_speech(rng, ln, sr)
        if not act.any():
            continue
        snr = float(rng.uniform(*p["snr_db"]))
        bed_rms = float(np.sqrt(np.mean(bed_ref[at: at + ln] ** 2) + 1e-12))
        sp_rms = float(np.sqrt(np.mean(sp[act] ** 2) + 1e-12))
        audio[at: at + ln] += (bed_rms * 10.0 ** (snr / 20.0) / sp_rms) * sp
    peak = float(np.abs(audio).max())
    if peak > 0.99:
        audio *= np.float32(0.99 / peak)
    return np.clip(np.rint(audio * 32767.0), -32768, 32767).astype(np.int16)


def write_wav(path: str, samples: np.ndarray, sr: int) -> None:
    """PCM16 mono RIFF/WAVE."""
    data = samples.astype("<i2").tobytes()
    hdr = (b"RIFF" + (36 + len(data)).to_bytes(4, "little") + b"WAVE"
           + b"fmt " + (16).to_bytes(4, "little") + (1).to_bytes(2, "little")
           + (1).to_bytes(2, "little") + int(sr).to_bytes(4, "little")
           + int(2 * sr).to_bytes(4, "little") + (2).to_bytes(2, "little")
           + (16).to_bytes(2, "little")
           + b"data" + len(data).to_bytes(4, "little"))
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(data)
        # on disk before the window: no writeback of the recordings in it
        f.flush()
        os.fsync(f.fileno())


def _bank(seed: int, params: Dict) -> List[np.ndarray]:
    rng = np.random.default_rng([seed, 0x62616E6B])
    sr = int(params["sample_rate"])
    tile = int(round(params["bed_tile_seconds"] * sr))
    bank = []
    for _ in range(int(params["bed_bank"])):
        k1, k2 = (KINDS[int(rng.integers(len(KINDS)))] for _ in range(2))
        bank.append(0.7 * synth_environment(rng, tile, k1, sr)
                    + 0.3 * synth_environment(rng, tile, k2, sr))
    return bank


def write_files(seed: int, params: Dict, indexes: List[int], out_dir: str) -> List[Dict]:
    """Recordings ``indexes`` of the mix (each from its own seed)."""
    bank = _bank(seed, params)
    sr = int(params["sample_rate"])
    out = []
    for i in indexes:
        pcm = make_recording(np.random.default_rng([seed, 0x66696C65, i]), bank, params)
        path = os.path.join(out_dir, f"rec{i:03d}.wav")
        write_wav(path, pcm, sr)
        out.append({"path": path, "sample_rate": sr, "frames": int(len(pcm)),
                    "seconds": len(pcm) / sr})
    return out


def generate(params: Dict, seed: int, out_dir: str) -> List[Dict]:
    """Write the mix's recordings into ``out_dir`` on ``workers`` processes;
    returns one record per file: {"path", "sample_rate", "frames",
    "seconds"}."""
    from benchmarks.harness import procpool

    seed = int(seed) & (2**63 - 1)
    os.makedirs(out_dir, exist_ok=True)
    n = int(params["files"])
    workers = max(1, min(int(params.get("workers", 1)), n, os.cpu_count() or 1))
    parts = [list(range(n))[w::workers] for w in range(workers)]
    got = procpool.map_calls(os.path.abspath(__file__), "write_files",
                             [(seed, params, p, out_dir) for p in parts], workers)
    return sorted((r for part in got for r in part), key=lambda r: r["path"])
