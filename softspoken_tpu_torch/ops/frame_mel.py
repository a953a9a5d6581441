"""Framing + DFT + mel frontend straight from a chunk buffer (K1).

Counterpart of ``softspoken_tpu/ops/pallas_frame_mel.py``.  The kernel is
``csrc/frame_mel.cu`` on the shared tensor-core core ``csrc/mel_core.cuh``
(CUDA C++ for sm_90a, see their headers for the design and the bound);
``log_mel_windows_fused_ref`` is its plain PyTorch version, built from
``ops/mel.py`` with the same truncated 768-bin tables.

``log_mel_windows_fused`` runs the plain version for tensors on the CPU and
launches the kernel for CUDA tensors; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import _build, count_launch, mel_core
from . import mel as melops

N_FREQS_PAD = 768   # mel support ends at bin 743; bins >= 768 weigh exactly 0
N_MELS = melops.N_MELS
FRAMES = melops.FRAMES
WINDOW_SAMPLES = melops.WINDOW_SAMPLES
NAME = "frame_mel"
_MODE_PARTS = {"highest": 3, "high": 2, "default": 1}  # bf16 parts of the DFT product


def tables() -> "tuple[np.ndarray, np.ndarray]":
    """(W (512, 1536) = [cos | sin] over 768 bins, fb (768, 128)), float32."""
    return melops.truncated_tables(N_FREQS_PAD)


def _check_args(mode: str, out_dtype: torch.dtype) -> None:
    if mode not in _MODE_PARTS:
        raise ValueError(f"mode must be 'highest', 'high' or 'default', got {mode!r}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")


def log_mel_windows_fused_ref(buf: torch.Tensor, starts: torch.Tensor,
                              mode: str = "highest",
                              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (N,) f32 + (B,) → (B, 128, 256)."""
    _check_args(mode, out_dtype)
    w, fb = (torch.from_numpy(t).to(buf.device) for t in tables())
    frames = melops.gather_frames(buf.to(torch.float32), starts)
    with melops.fp32_matmul():
        proj = melops.dft_product(frames, w, mode)
        re, im = proj[..., :N_FREQS_PAD], proj[..., N_FREQS_PAD:]
        mel = melops.fixed_order_matmul(re * re + im * im, fb)
    mel = torch.sqrt(torch.log10(mel + 1.0))
    return mel.transpose(-1, -2).to(out_dtype)


@lru_cache(maxsize=8)
def _device_tables(device: torch.device, mode: str) -> torch.Tensor:
    """The kernel's bf16 tile stream of W and fb for ``mode`` on ``device``
    (``ops/mel_core.py``)."""
    return mel_core.stream_tables(_MODE_PARTS[mode]).to(device)


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    fn = lib.frame_mel_launch
    P = ctypes.c_void_p
    fn.argtypes = [P, ctypes.c_longlong, P, ctypes.c_int, P, P,
                   ctypes.c_int, ctypes.c_int, P]
    fn.restype = ctypes.c_int
    return lib


def log_mel_windows_fused(buf: torch.Tensor, starts: torch.Tensor,
                          mode: str = "highest",
                          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(N,) f32 chunk buffer + (B,) int32 window starts → (B, 128, 256) log-mel.

    Drop-in for ``ops.mel.log_mel_windows`` on the fused-engine chunk path.
    Every window must satisfy ``0 <= start <= N - 66150``; on the card a
    window outside that range comes out as NaN (the caller validates starts
    on the host before uploading them).
    """
    _check_args(mode, out_dtype)
    if buf.device.type == "cpu":
        return log_mel_windows_fused_ref(buf, starts, mode, out_dtype)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    if buf.dtype != torch.float32 or buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError("buf must be a contiguous 1-D float32 tensor")
    if (starts.dtype != torch.int32 or starts.dim() != 1
            or not starts.is_contiguous() or starts.device != buf.device):
        raise ValueError("starts must be a contiguous 1-D int32 tensor on buf's device")
    B = starts.shape[0]
    out = torch.empty((B, N_MELS, FRAMES), dtype=out_dtype, device=buf.device)
    if B == 0:
        return out
    # the kernel runs on the current device: make it buf's, whatever the
    # calling thread's current device is
    with torch.cuda.device(buf.device):
        rc = _lib().frame_mel_launch(
            buf.data_ptr(), buf.shape[0], starts.data_ptr(), B,
            _device_tables(buf.device, mode).data_ptr(), out.data_ptr(),
            _MODE_PARTS[mode], int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream(buf.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"frame_mel kernel launch failed: cudaError {rc}")
    count_launch(NAME)
    return out
