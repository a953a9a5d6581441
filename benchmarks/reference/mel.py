"""The detector's log-mel frontend, written from its definition.

The reference network's in-model torchaudio frontend
(``root/code/backend/pytorch_neural_nets.py`` of AVianEco/Softspoken):

    MelSpectrogram(sample_rate=22050, n_fft=2048, win_length=512,
                   hop_length=256, n_mels=128, f_max=8000)
    -> sqrt(log10(power + 1)) -> the first 256 of 259 frames

with torchaudio's defaults: power 2, HTK mel scale, no filterbank norm, a
periodic Hann window of 512 centred in the 2048-point frame, center=True
with reflect padding.  Here as frames @ DFT matrix (all 1,025 bins) in
float32 with TF32 off, so that the control can round the product's operands
(``quant.py``); ``stft_log_mel`` is the same function through
``torch.stft``, which the tests hold it against.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

SR = 22050
N_FFT = 2048
WIN = 512
HOP = 256
N_MELS = 128
F_MAX = 8000.0
FRAMES = 256
WINDOW_SAMPLES = 3 * SR
N_FREQS = N_FFT // 2 + 1


def hann(n: int) -> np.ndarray:
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))


def mel_fbank() -> np.ndarray:
    """(1025, 128) HTK triangles from 0 to 8 kHz, float64."""
    def hz2mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    freqs = np.linspace(0.0, SR / 2.0, N_FREQS)
    m = np.linspace(hz2mel(0.0), hz2mel(F_MAX), N_MELS + 2)
    f_pts = 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up))


def dft_matrix() -> np.ndarray:
    """(512, 2050): the Hann-windowed frame's real DFT, [cos | sin], where
    the 512 samples sit at offset 768 of the 2048-point frame."""
    j = np.arange(WIN, dtype=np.float64)[:, None]
    k = np.arange(N_FREQS, dtype=np.float64)[None, :]
    ph = 2.0 * np.pi * k * (j + (N_FFT - WIN) // 2) / N_FFT
    w = hann(WIN)[:, None]
    return np.concatenate([w * np.cos(ph), w * np.sin(ph)], axis=1)


def frames(windows: torch.Tensor) -> torch.Tensor:
    """(B, 66150) windows -> (B, 256, 512) frames: with center=True frame k
    covers window samples [256k - 256, 256k + 256), reflected at the left
    edge (sample -p is sample p)."""
    pad = torch.cat([windows[:, 1: HOP + 1].flip(-1), windows], dim=1)  # index p + 256
    idx = torch.arange(FRAMES, device=windows.device)[:, None] * HOP + torch.arange(
        WIN, device=windows.device)[None, :]
    return pad[:, idx]


class LogMel:
    """Compressed log-mel on ``device``; ``q`` rounds the DFT product's two
    operands (None: float32)."""

    def __init__(self, device, q: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.w = torch.from_numpy(dft_matrix()).float().to(device)
        self.fb = torch.from_numpy(mel_fbank()).float().to(device)
        self.q = q

    def __call__(self, windows: torch.Tensor) -> torch.Tensor:
        """(B, 66150) float32 -> (B, 128, 256) float32."""
        f = frames(windows.float())
        w = self.w
        if self.q is not None:
            f, w = self.q(f), self.q(w)
        proj = f @ w
        power = proj[..., :N_FREQS] ** 2 + proj[..., N_FREQS:] ** 2
        mel = power @ self.fb
        return torch.sqrt(torch.log10(mel + 1.0)).transpose(1, 2)


def stft_log_mel(windows: torch.Tensor) -> torch.Tensor:
    """The same function through ``torch.stft`` (torchaudio's recipe)."""
    win = torch.from_numpy(hann(WIN)).float().to(windows.device)
    spec = torch.stft(windows.float(), N_FFT, HOP, WIN, window=win, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2                      # (B, 1025, 259)
    fb = torch.from_numpy(mel_fbank()).float().to(windows.device)
    mel = torch.einsum("bft,fm->bmt", power, fb)
    return torch.sqrt(torch.log10(mel + 1.0))[..., :FRAMES]
