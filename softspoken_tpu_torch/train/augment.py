"""The audio augmentation suite (the JAX package's ``train/augment.py``):
each augmentation takes and returns a ``(B, n)`` float32 tensor, on any
device.

The reference implements eight augmentations as per-clip numpy/scipy
routines (``voice_activity.py:299-886``):

  change_pitch            — linear-interp resample (voice_activity.py:386-441)
  change_speed            — STFT phase-vocoder time stretch (:467-643): framed
                            rFFT, the phase accumulator as a cumulative sum
                            over frames, overlap-add of four shifted views
  add_reverb              — log-spaced delay taps with normalized exponential
                            decays (:734-788)
  reduce_volume           — scalar gain (:791-802)
  add_echo                — single delayed copy (:805-823)
  bandpass_filter         — 1st-order Butterworth band-pass (:826-846); the
                            digital filter's exact frequency response applied
                            via rFFT (circular filtering: differs from
                            lfilter's causal edge transient only)
  add_harmonic_distortion — sign(x)·(1−exp(−k|x|)) waveshaper (:849-861)
  compress_dynamics       — hard-knee compressor above a dB threshold (:864-886)

plus ``gain_ramp``, a linear-in-dB gain across the clip (not a reference
augmentation; opt-in).  Parameters are drawn by ``get_parameters`` from a
``torch.Generator`` in the ranges of ``PARAM_RANGES``: the ranges are the
JAX package's, the values for a given seed are not (``jax.random`` streams
cannot be reproduced in torch).

The on-device synthetic trainer has its own per-row-tensor versions of these
(``train/device_data.py``); this module is the host trainer's
(``train/data.py::build_batch``), with one scalar parameter set per call.
Where the two compute the same formula (volume, distortion, compressor),
this module calls the device trainer's body.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .device_data import _compress_dynamics, _harmonic_distortion, _reduce_volume

SR = 22050
CLIP = 66150

# reference ranges: voice_activity.py:314-343
PARAM_RANGES: Dict[str, Dict[str, Tuple[float, float]]] = {
    "change_pitch": {"pitch_factor": (-3.0, 3.0)},
    "change_speed": {"speed_factor": (0.80, 1.2)},
    "add_reverb": {
        "reverb_level": (0.2, 0.8),
        "decay_time": (0.2, 1.0),
        "num_delays": (1.0, 5.0),
    },
    "reduce_volume": {"reduction_level": (0.1, 0.99)},
    "add_echo": {"echo_delay": (0.1, 0.7), "decay_factor": (0.3, 0.7)},
    "bandpass_filter": {"low_freq": (100.0, 500.0), "high_freq": (600.0, 2500.0)},
    "add_harmonic_distortion": {"distortion_level": (10.0, 50.0)},
    "compress_dynamics": {
        "compression_ratio": (1.5, 6.0),
        "threshold_level": (-40.0, -10.0),
    },
    # not a reference augmentation: a within-clip channel-gain ramp, the
    # analog of the slow-fading channel of the evaluation grid; opt-in only
    "gain_ramp": {"start_db": (-18.0, 0.0), "end_db": (-18.0, 0.0)},
}


def get_parameters(generator: torch.Generator,
                   augmentations: Sequence[str]) -> List[Dict[str, float]]:
    """Random parameters per augmentation, one float32 uniform draw per key
    in ``PARAM_RANGES`` order (reference: voice_activity.py:299-350).
    Names without a range are skipped, as in the JAX package."""
    out = []
    for aug in augmentations:
        spec = PARAM_RANGES.get(aug)
        if spec is None:
            continue
        out.append({key: float(torch.empty((), device=generator.device)
                               .uniform_(lo, hi, generator=generator))
                    for key, (lo, hi) in spec.items()})
    return out


def _hann(n: int, device) -> torch.Tensor:
    """``np.hanning(n)`` (the symmetric window) as float32."""
    return torch.from_numpy(np.hanning(n).astype(np.float32)).to(device)


# --------------------------------------------------------------------------
# the augmentations: all take and return (B, n) float32
# --------------------------------------------------------------------------

def change_pitch(audio: torch.Tensor, sr: int = SR, pitch_factor: float = 0.0) -> torch.Tensor:
    """Linear-interpolation pitch shift by ``pitch_factor`` semitones.

    As in the reference code (voice_activity.py:406), the source index is
    j/factor, so positive semitones lower the pitch.
    """
    n = audio.shape[-1]
    # the factor as a float32 tensor: a CUDA tensor divided by a Python
    # scalar is multiplied by its float32 reciprocal, one ulp off the
    # quotient the CPU (and the JAX package) compute, and one ulp of a
    # source index near 50,000 is 1/256 of a sample
    factor = torch.tensor(2.0 ** (pitch_factor / 12.0), dtype=torch.float32,
                          device=audio.device)
    src = torch.arange(n, dtype=torch.float32, device=audio.device) / factor
    lo = torch.floor(src).long().clamp(0, n - 1)
    hi = (lo + 1).clamp(0, n - 1)
    w = src - lo.float()
    return ((1.0 - w) * audio[..., lo] + w * audio[..., hi]).to(torch.float32)


def _stft(x: torch.Tensor, n_fft: int = 1024, hop: int = 256) -> torch.Tensor:
    """Non-centered framed rFFT with a symmetric Hann window (the reference's
    own stft, voice_activity.py:467-499) → (..., n_frames, n_fft//2+1)."""
    frames = x.unfold(-1, n_fft, hop) * _hann(n_fft, x.device)
    return torch.fft.rfft(frames)


def _istft(spec: torch.Tensor, n: int, n_fft: int = 1024, hop: int = 256) -> torch.Tensor:
    """Windowed overlap-add inverse (voice_activity.py:501-528).

    With ``n_fft = q·hop`` the overlap-add is q shifted views of the frames
    split into hop-long quarters, added in a fixed order (no scatter, so the
    card's sum does not vary from run to run).
    """
    frames = torch.fft.irfft(spec, n=n_fft).to(torch.float32) * _hann(n_fft, spec.device)
    if n_fft % hop:
        raise ValueError(f"n_fft={n_fft} is not a multiple of hop={hop}")
    q = n_fft // hop
    n_frames = frames.shape[-2]
    parts = frames.reshape(frames.shape[:-1] + (q, hop))      # (..., T, q, hop)
    out = None
    for j in range(q):
        # quarter j of frame t lands on output block t + j
        blk = F.pad(parts[..., j, :], (0, 0, j, q - 1 - j))     # (..., T+q-1, hop)
        out = blk if out is None else out + blk
    out = out.reshape(frames.shape[:-2] + ((n_frames + q - 1) * hop,))
    out_len = out.shape[-1]                                   # hop·(T−1) + n_fft
    return out[..., :n] if out_len >= n else F.pad(out, (0, n - out_len))


def _phase_vocoder(spec: torch.Tensor, speed_factor: float, hop: int = 256,
                   out_frames: int = None) -> torch.Tensor:
    """Time-stretch an STFT (..., T, F) by ``speed_factor``.

    ``out_frames`` sets the output frame count; frames beyond the stretched
    extent are zeroed.  Output frame t reads input position t·speed, and its
    phase is frame 0's plus the running sum of the wrapped phase advances
    times speed: one cumulative sum over the frame axis (the JAX package's
    ``lax.scan`` adds the same terms one frame at a time).
    """
    n_frames = spec.shape[-2]
    if out_frames is None:
        out_frames = n_frames
    mag = spec.abs()
    phase = torch.angle(spec)
    speed = torch.tensor(speed_factor, dtype=torch.float32)
    t = torch.arange(1, out_frames, dtype=torch.float32) * speed
    int_t = torch.floor(t).long().clamp(0, n_frames - 2)
    frac = (t - int_t.float()).to(spec.device)[:, None]          # (T', 1)
    valid = (t < n_frames - 1).float().to(spec.device)[:, None]
    i1 = int_t.to(spec.device)
    m1, m2 = mag.index_select(-2, i1), mag.index_select(-2, i1 + 1)
    p1, p2 = phase.index_select(-2, i1), phase.index_select(-2, i1 + 1)
    m = (1.0 - frac) * m1 + frac * m2
    dphase = torch.remainder(p2 - p1 + np.pi, 2.0 * np.pi) - np.pi
    acc = phase[..., 0:1, :] + torch.cumsum(dphase * speed.to(spec.device), dim=-2)
    frames = torch.polar(m * valid, acc)
    return torch.cat([spec[..., 0:1, :], frames], dim=-2)


def change_speed(audio: torch.Tensor, sr: int = SR, speed_factor: float = 1.0,
                 n_fft: int = 1024, hop: int = 256) -> torch.Tensor:
    """Phase-vocoder time stretch, clip length preserved.

    As in the reference, speed 1.0 returns the input (voice_activity.py
    :608-609); any other speed goes through the STFT→iSTFT round trip, which
    is not unit-gain (the Hann window is applied both ways with no
    window-sum normalization): ~1.5× the level.  A slowdown emits more
    frames than the input, so the output is sized to keep the stretched
    tail up to the clip length.
    """
    sf = float(speed_factor)
    if sf == 1.0:
        return audio.to(torch.float32)
    n = audio.shape[-1]
    spec = _stft(audio, n_fft, hop)
    n_frames = spec.shape[-2]
    out_frames = n_frames if sf >= 1.0 else int(np.ceil((n_frames - 1) / sf)) + 1
    return _istft(_phase_vocoder(spec, sf, hop, out_frames=out_frames), n, n_fft, hop)


def add_reverb(audio: torch.Tensor, sr: int = SR, reverb_level: float = 0.5,
               decay_time: float = 0.5, num_delays: float = 5) -> torch.Tensor:
    """Log-spaced delay taps with normalized exponential decay weights."""
    n = audio.shape[-1]
    k = int(num_delays)
    delays = np.linspace(0, int(sr * decay_time), k + 1, dtype=int)[1:]
    decays = np.exp(-np.linspace(0, 3, k))
    decays = decays / decays.sum()
    reverb = torch.zeros_like(audio)
    for d, g in zip(delays, decays):
        if 0 < d < n:
            reverb[..., d:] += audio[..., : n - d] * float(g)
    return ((1.0 - reverb_level) * audio + reverb_level * reverb).to(torch.float32)


def reduce_volume(audio: torch.Tensor, sr: int = SR,
                  reduction_level: float = 0.5) -> torch.Tensor:
    return _reduce_volume(audio, {"level": reduction_level}).to(torch.float32)


def gain_ramp(audio: torch.Tensor, sr: int = SR, start_db: float = 0.0,
              end_db: float = 0.0) -> torch.Tensor:
    """Linear-in-dB gain ramp across the clip (not a reference augmentation)."""
    db = torch.linspace(start_db, end_db, audio.shape[-1], dtype=torch.float32,
                        device=audio.device)
    return (audio * 10.0 ** (db / 20.0)).to(torch.float32)


def add_echo(audio: torch.Tensor, sr: int = SR, echo_delay: float = 0.5,
             decay_factor: float = 0.5) -> torch.Tensor:
    n = audio.shape[-1]
    d = int(echo_delay * sr)
    echo = torch.zeros_like(audio)
    if 0 < d < n:
        echo[..., d:] = audio[..., : n - d] * decay_factor
    return (audio + echo).to(torch.float32)


def _butter1_band_coeffs(low_freq: float, high_freq: float, sr: int):
    """scipy.signal.butter(1, [lo, hi], 'band') digital coefficients."""
    import scipy.signal

    nyq = 0.5 * sr
    return scipy.signal.butter(1, [low_freq / nyq, high_freq / nyq], btype="band")


def bandpass_filter(audio: torch.Tensor, sr: int = SR, low_freq: float = 300.0,
                    high_freq: float = 2000.0) -> torch.Tensor:
    """1st-order Butterworth band-pass, applied via the filter's exact
    digital frequency response in the rFFT domain (circular filtering)."""
    b, a = _butter1_band_coeffs(float(low_freq), float(high_freq), sr)
    n = audio.shape[-1]
    z = np.exp(-2j * np.pi * np.fft.rfftfreq(n))  # e^{-jω}
    h = np.polyval(b[::-1], z) / np.polyval(a[::-1], z)
    spec = torch.fft.rfft(audio) * torch.from_numpy(h.astype(np.complex64)).to(audio.device)
    return torch.fft.irfft(spec, n=n).to(torch.float32)


def add_harmonic_distortion(audio: torch.Tensor, sr: int = SR,
                            distortion_level: float = 0.5) -> torch.Tensor:
    return _harmonic_distortion(audio, {"k": distortion_level}).to(torch.float32)


def compress_dynamics(audio: torch.Tensor, sr: int = SR, compression_ratio: float = 2.0,
                      threshold_level: float = -20.0) -> torch.Tensor:
    """Hard-knee compressor, the device trainer's body with scalar
    parameters; it keeps the reference's rectification of quiet negative
    samples (``train/device_data.py::_compress_dynamics``)."""
    return _compress_dynamics(audio, {"threshold_db": threshold_level,
                                      "ratio": compression_ratio}).to(torch.float32)


FUNC_MAP = {
    "change_pitch": change_pitch,
    "change_speed": change_speed,
    "add_reverb": add_reverb,
    "reduce_volume": reduce_volume,
    "gain_ramp": gain_ramp,
    "add_echo": add_echo,
    "bandpass_filter": bandpass_filter,
    "add_harmonic_distortion": add_harmonic_distortion,
    "compress_dynamics": compress_dynamics,
}


def apply_augmentations(
    audio: torch.Tensor,
    sr: int = SR,
    augmentations: Sequence[str] = (),
    augmentation_params: Sequence[Dict[str, float]] = (),
) -> torch.Tensor:
    """Apply the named augmentations in sequence (voice_activity.py:352-384)."""
    for name, params in zip(augmentations, augmentation_params):
        fn = FUNC_MAP.get(name)
        if fn is None:
            raise KeyError(f"no such augmentation: {name}")
        audio = fn(audio, sr, **params)
    return audio
