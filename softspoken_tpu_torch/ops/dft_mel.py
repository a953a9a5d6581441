"""DFT → power → mel → compression over gathered frames (K2).

Counterpart of ``softspoken_tpu/ops/pallas_mel.py``, the opt-in
``mel_kernel="pallas"`` frontend.  The kernel is ``csrc/dft_mel.cu`` on the
shared tensor-core core ``csrc/mel_core.cuh`` (CUDA C++ for sm_90a, see
their headers for the design and the bound): a six-pass bf16 split product,
float32 class.  ``log_mel_from_frames_dft_ref`` is its plain PyTorch
version, in float32.  Both skip DFT bins 768-1023, whose mel weight is
exactly 0 (``tables`` checks it), so they sum the same terms; the TPU
kernel computes 1024 bins.

``log_mel_from_frames_dft`` runs the plain version for tensors on the CPU
and launches the kernel for CUDA tensors; there is no fallback between the
two.  ``log_mel_windows_dft`` gathers the frames with plain torch indexing
first, as the JAX wrapper leaves its gather to XLA.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import _build, count_launch, mel_core
from . import mel as melops

ROWS_PER_TILE = 256  # the TPU kernel's row tile; B·F must be a multiple
N_BINS = mel_core.N_BINS  # 768: mel support ends at bin 743
N_MELS = melops.N_MELS
WIN = melops.WIN_LENGTH
NAME = "dft_mel"
_N_PARTS = 3         # bf16 parts of each operand: the float32-class product


def tables() -> "tuple[np.ndarray, np.ndarray]":
    """(W (512, 1536) = [cos | sin] over 768 bins, fb (768, 128)), float32,
    with the exact-truncation check."""
    return melops.truncated_tables(N_BINS)


def _check_frames(frames: torch.Tensor) -> None:
    if frames.dim() != 3 or frames.shape[-1] != WIN:
        raise ValueError(f"frames must be (B, F, {WIN}), got {tuple(frames.shape)}")
    if (frames.shape[0] * frames.shape[1]) % ROWS_PER_TILE:
        raise ValueError("batch·frames must tile by 256 rows")


def log_mel_from_frames_dft_ref(frames: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (B, F, 512) → (B, 128, F), float32 throughout."""
    _check_frames(frames)
    w, fb = (torch.from_numpy(t).to(frames.device) for t in tables())
    with melops.fp32_matmul():
        proj = frames.to(torch.float32) @ w
        re, im = proj[..., :N_BINS], proj[..., N_BINS:]
        mel = melops.fixed_order_matmul(re * re + im * im, fb)
    return torch.sqrt(torch.log10(mel + 1.0)).transpose(-1, -2)


@lru_cache(maxsize=8)
def _device_tables(device: torch.device) -> torch.Tensor:
    """The kernel's three-part bf16 tile stream of W and fb on ``device``
    (``ops/mel_core.py``)."""
    return mel_core.stream_tables(_N_PARTS).to(device)


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    fn = lib.dft_mel_launch
    P = ctypes.c_void_p
    fn.argtypes = [P, ctypes.c_longlong, ctypes.c_int, P, P, P]
    fn.restype = ctypes.c_int
    return lib


def log_mel_from_frames_dft(frames: torch.Tensor) -> torch.Tensor:
    """(B, F, 512) frames → (B, 128, F) compressed log-mel, float32.

    B·F must be a multiple of 256 (the TPU kernel's row tile), as in the JAX
    package.  On the card the frames must be contiguous float32.
    """
    _check_frames(frames)
    if frames.device.type == "cpu":
        return log_mel_from_frames_dft_ref(frames)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    if frames.dtype != torch.float32 or not frames.is_contiguous():
        raise ValueError("frames must be a contiguous float32 tensor")
    B, F, _ = frames.shape
    out = torch.empty((B, N_MELS, F), dtype=torch.float32, device=frames.device)
    if B * F == 0:
        return out
    with torch.cuda.device(frames.device):  # the kernel runs on the current device
        rc = _lib().dft_mel_launch(frames.data_ptr(), B * F, F,
                                   _device_tables(frames.device).data_ptr(),
                                   out.data_ptr(),
                                   torch.cuda.current_stream(frames.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dft_mel kernel launch failed: cudaError {rc}")
    count_launch(NAME)
    return out


def log_mel_windows_dft(waveform: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Gather + DFT→mel kernel; drop-in for ``ops.mel.log_mel_windows``:
    (N,) buffer + (B,) window starts → (B, 128, 256) float32."""
    frames = melops.gather_frames(waveform.to(torch.float32), starts)
    return log_mel_from_frames_dft(frames)
