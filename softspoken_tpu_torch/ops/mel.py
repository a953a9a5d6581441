"""Log-mel frontend in plain PyTorch: the tables and the two-matmul chain.

Reproduces the reference model's in-model torchaudio frontend
(``pytorch_neural_nets.py:92-99, 142-153``):

    MelSpectrogram(sample_rate=22050, n_fft=2048, win_length=512,
                   hop_length=256, n_mels=128, f_max=8000)
    → sqrt(log10(power + 1))          (:80-81, 147)
    → trim 259 frames → 256           (:150)

with torchaudio's defaults: power=2.0, HTK mel scale, norm=None, periodic Hann
window zero-padded 512→2048, center=True, pad_mode="reflect".  The Hann window
is only 512 wide inside the 2048-point FFT, so each DFT is a (512 → 1025-bin)
projection: frames(B·256, 512) @ W(512, 2050), square-and-add, then the
(1025 → 128) mel product.

This chain is the parity-mode frontend and the plain version that the CUDA
kernel in ``ops/frame_mel.py`` is held against.  The tables are built in
float64 with numpy and stored as float32, exactly as the JAX package's
``ops/mel.py`` builds them.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch

SR = 22050
N_FFT = 2048
WIN_LENGTH = 512
HOP_LENGTH = 256
N_MELS = 128
F_MIN = 0.0
F_MAX = 8000.0
FRAMES = 256                      # trimmed from 259 (pytorch_neural_nets.py:150)
WINDOW_SAMPLES = SR * 3           # 66150
N_FREQS = N_FFT // 2 + 1          # 1025
_PAD = (N_FFT - WIN_LENGTH) // 2  # 768: window's offset inside the FFT frame

MODES = ("highest", "high", "default")


def hann_periodic(n: int) -> np.ndarray:
    """torch.hann_window(n) — periodic Hann, float64."""
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))).astype(np.float64)


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@lru_cache(maxsize=4)
def mel_filterbank(
    n_freqs: int = N_FREQS,
    f_min: float = F_MIN,
    f_max: float = F_MAX,
    n_mels: int = N_MELS,
    sample_rate: int = SR,
) -> np.ndarray:
    """torchaudio.functional.melscale_fbanks(htk, norm=None) → (n_freqs, n_mels)."""
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_min, m_max = hz_to_mel_htk(f_min), hz_to_mel_htk(f_max)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = mel_to_hz_htk(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


@lru_cache(maxsize=4)
def dft_matrices() -> np.ndarray:
    """Window-folded real DFT, stacked: (WIN_LENGTH, 2*N_FREQS) float32.

    W[j, k]         = hann[j] * cos(2π k (j+768) / 2048)
    W[j, k+N_FREQS] = hann[j] * sin(2π k (j+768) / 2048)
    """
    j = np.arange(WIN_LENGTH, dtype=np.float64)[:, None]
    k = np.arange(N_FREQS, dtype=np.float64)[None, :]
    phase = 2.0 * np.pi * k * (j + _PAD) / N_FFT
    w = hann_periodic(WIN_LENGTH)[:, None]
    return np.concatenate([w * np.cos(phase), w * np.sin(phase)], axis=1).astype(
        np.float32
    )


@lru_cache(maxsize=4)
def truncated_tables(n_bins: int) -> "tuple[np.ndarray, np.ndarray]":
    """(W (512, 2·n_bins) = [cos | sin] over the first n_bins DFT bins,
    fb (n_bins, 128)), float32.  Raises unless the filterbank is exactly
    zero from bin n_bins on, so that the truncation drops only zero terms."""
    w_full, fb_full = dft_matrices(), mel_filterbank()
    if not np.all(fb_full[n_bins:, :] == 0.0):
        raise ValueError(f"mel filterbank support exceeds {n_bins} bins")
    w = np.concatenate([w_full[:, :n_bins], w_full[:, N_FREQS: N_FREQS + n_bins]], axis=1)
    return np.ascontiguousarray(w), np.ascontiguousarray(fb_full[:n_bins])


@lru_cache(maxsize=4)
def frame_index_table(frames: int = FRAMES) -> np.ndarray:
    """(frames, WIN_LENGTH) int32 sample offsets of each frame relative to
    its window's start, the layout ``frames_from_window`` slices.

    Frame k ≥ 1 covers window samples [(k-1)·256, (k+1)·256); frame 0 is
    the one frame in torch.stft's reflect pad, where padded position p maps
    to window sample |p|.  Frames ≥ 256 touch the right pad; the model
    trims them (pytorch_neural_nets.py:150), so none is computed.
    """
    idx = np.empty((frames, WIN_LENGTH), dtype=np.int32)
    base = np.arange(WIN_LENGTH, dtype=np.int32)
    for k in range(1, frames):
        idx[k] = (k - 1) * HOP_LENGTH + base
    pos = np.arange(-HOP_LENGTH, HOP_LENGTH + (WIN_LENGTH - 2 * HOP_LENGTH), dtype=np.int32)
    idx[0] = np.abs(pos)
    return idx


def frames_from_window(w: torch.Tensor) -> torch.Tensor:
    """(..., ≥66150) windows → (..., 256, 512) STFT frames.

    Frames 1..255 cover window samples [(k-1)·256, (k+1)·256); frame 0 is the
    one frame in torch.stft's reflect pad: padded positions -256..255 map to
    window sample |p|.
    """
    b = w[..., : (FRAMES + 1) * HOP_LENGTH].unflatten(-1, (FRAMES + 1, HOP_LENGTH))
    mid = torch.cat([b[..., : FRAMES - 1, :], b[..., 1:FRAMES, :]], dim=-1)
    f0 = torch.cat([w[..., 1: HOP_LENGTH + 1].flip(-1), w[..., :HOP_LENGTH]], dim=-1)
    return torch.cat([f0.unsqueeze(-2), mid], dim=-2)


def gather_frames(waveform: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """(N,) buffer + (B,) window starts → (B, 256, 512) frames.

    Every window must lie inside the buffer.  On the CPU the check raises;
    on the card a window outside comes out as NaN, as in the frame_mel
    kernel, so that the check never waits for the device.  Neither reads a
    clamped, shifted window as if it were real.
    """
    starts = starts.to(torch.int64)
    n = waveform.shape[0]
    if starts.numel() and n < WINDOW_SAMPLES:
        raise ValueError("buffer shorter than one window")
    if waveform.device.type == "cpu":
        if starts.numel() and (int(starts.min()) < 0
                               or int(starts.max()) + WINDOW_SAMPLES > n):
            raise ValueError("window start out of the buffer's range")
        bad = None
    else:
        bad = (starts < 0) | (starts + WINDOW_SAMPLES > n)
        starts = torch.where(bad, 0, starts)
    idx = starts[:, None] + torch.arange(WINDOW_SAMPLES, device=waveform.device)
    frames = frames_from_window(waveform[idx])
    if bad is not None:
        frames = frames.masked_fill(bad[:, None, None], float("nan"))
    return frames


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_parts(x: torch.Tensor, n: int) -> "list[torch.Tensor]":
    """x as n bf16 values carried in float32: part 0 is bf16(x), part p is
    bf16 of what the parts before it left over (round to nearest even on
    the float32 value each time).  Three parts hold 8+8+8 mantissa bits and
    sum back to a float32 x exactly; fewer parts sum to x as far as they
    reach.  This is the split the CUDA kernels make in registers."""
    parts, rest = [], x
    for _ in range(n):
        parts.append(_bf16(rest))
        rest = rest - parts[-1]
    return parts


def dft_product(frames: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """frames @ w in the mode's arithmetic, float32 out.

    "highest": float32 products (TF32 must be off, see ``fp32_matmul``).
    "high": the bf16x3 split of the JAX kernel (``_dft_dot_bf16``):
    hi·hi + hi·lo + lo·hi with hi = bf16(x), lo = bf16(x − hi).
    "default": one product of bf16-rounded operands, float32 sums.
    The bf16 values are carried in float32, so every product is exact and
    only the summation order differs from a bf16 tensor-core product.
    """
    if mode == "highest":
        return frames @ w
    if mode == "high":
        (f_hi, f_lo), (w_hi, w_lo) = bf16_parts(frames, 2), bf16_parts(w, 2)
        return f_hi @ w_hi + f_hi @ w_lo + f_lo @ w_hi
    if mode != "default":
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return _bf16(frames) @ _bf16(w)


_K_SLICE = 16


def fixed_order_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for a (..., K) and b (K, N), with a summation order on the
    CPU that does not depend on how many threads the BLAS gets.

    On the CPU the BLAS splits a long reduction across its threads when N is
    narrow: the 1,025-bin mel product (N = 128) rounds three ways under 1,
    2, 3 and 8 threads, and the resampler's matrix-vector product (N = 1,
    integer decimation such as 44.1 kHz) under every team size.  Here the
    reduction runs in 16-term slices added in order, each slice one product
    too short to be split; a matrix-vector product adds its terms one by
    one.  On the card ``a @ b`` as it is.
    """
    if a.device.type != "cpu":
        return a @ b
    k_len, n = b.shape
    if n == 1:
        out = a[..., 0:1] * b[0]
        for k in range(1, k_len):
            out = out + a[..., k: k + 1] * b[k]
        return out
    out = a[..., :_K_SLICE] @ b[:_K_SLICE]
    for k in range(_K_SLICE, k_len, _K_SLICE):
        out = out + a[..., k: k + _K_SLICE] @ b[k: k + _K_SLICE]
    return out


@lru_cache(maxsize=8)
def _device_tables(device: torch.device) -> "tuple[torch.Tensor, torch.Tensor]":
    """(W, fb) on ``device``, uploaded once: a pageable copy per call would
    block the host (the training step calls the chain three times)."""
    return (torch.from_numpy(dft_matrices()).to(device),
            torch.from_numpy(mel_filterbank()).to(device))


def log_mel_from_frames(frames: torch.Tensor, mode: str = "highest",
                        fixed_order: bool = True) -> torch.Tensor:
    """(B, F, 512) frames → (B, n_mels, F) compressed log-mel, float32.
    ``fixed_order`` sums the mel product with ``fixed_order_matmul``, so
    that a detection grid on the CPU is the same under any thread count."""
    w, fb = _device_tables(frames.device)
    with fp32_matmul():
        proj = dft_product(frames.to(torch.float32), w, mode)
        re, im = proj[..., :N_FREQS], proj[..., N_FREQS:]
        power = re * re + im * im
        mel = fixed_order_matmul(power, fb) if fixed_order else power @ fb
    mel = torch.sqrt(torch.log10(mel + 1.0))
    return mel.transpose(-1, -2)


def log_mel_windows(waveform: torch.Tensor, starts: torch.Tensor,
                    mode: str = "highest") -> torch.Tensor:
    """Gather + DFT + mel + compression: (B, n_mels, 256) float32."""
    return log_mel_from_frames(gather_frames(waveform.to(torch.float32), starts), mode)


def log_mel_single(waveform: np.ndarray, mode: str = "highest", device=None) -> np.ndarray:
    """One 66150-sample window → (n_mels, 256) float32 numpy, through the
    plain chain on ``device`` (default: the CUDA card, as ``Detector``;
    ``device="cpu"`` on the host)."""
    from ..engine.detector import resolve_device

    wf = torch.as_tensor(np.asarray(waveform, np.float32), device=resolve_device(device))
    out = log_mel_windows(wf, torch.zeros(1, dtype=torch.int32, device=wf.device), mode)
    return out[0].cpu().numpy()


def train_mel_mode(device: torch.device) -> str:
    """The mel mode of the training frontend on ``device``.

    The JAX trainer calls ``log_mel_clips`` at ``precision=None``, the
    backend's default: one bf16 pass on its accelerator, which is what its
    fast-mode serving computes, and float32 on the CPU.  The port does the
    same: "default" on the card (the mode fast-mode inference resolves to),
    "highest" on the CPU.
    """
    return "default" if torch.device(device).type == "cuda" else "highest"


def log_mel_clips(clips: torch.Tensor, mode: str = "highest") -> torch.Tensor:
    """(B, 66150) independent 3 s clips → (B, n_mels, 256) compressed log-mel,
    float32: each clip is its own window.  The training batch synthesizer
    calls it with ``train_mel_mode(device)``; training makes no claim of
    bit-equal runs, so its mel product keeps the BLAS's own order."""
    return log_mel_from_frames(frames_from_window(clips.to(torch.float32)), mode,
                               fixed_order=False)


_tf32_lock = threading.Lock()
_tf32_holders = 0
_tf32_saved = (False, False)


@contextmanager
def fp32_matmul():
    """Pin float32 matmuls and convolutions to full float32 while inside.

    On CUDA, cuDNN convolutions default to TF32 (about three decimal digits)
    and a caller may have turned TF32 on for matmuls; the resampler, the
    parity path and the "highest" mel chain need true float32.

    The flags are process-global, so the guard is reference-counted under a
    lock: the first holder saves them and turns TF32 off, and only the last
    one to leave restores them.  Threads detecting files side by side never
    see TF32 come back on while one of them is still inside.
    """
    global _tf32_holders, _tf32_saved
    with _tf32_lock:
        if _tf32_holders == 0:
            _tf32_saved = (torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _tf32_holders += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_holders -= 1
            if _tf32_holders == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _tf32_saved
