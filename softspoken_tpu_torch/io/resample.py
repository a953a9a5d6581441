"""Polyphase sample-rate conversion, on the host and on the device.

Same filter and geometry as the JAX package's ``io/resample.py`` (a
Kaiser-windowed-sinc design comparable to librosa's kaiser_best, standing in
for the reference's soxr resampler, ``voice_activity.py:65-67``): the numpy
and scipy helpers below are copies.  Two paths share the taps:

  * ``resample`` — host, ``scipy.signal.resample_poly`` in float64.  The JAX
    package prefers its C++ polyphase (``io/native.py``) and falls back to
    the same scipy call; the two differ by float round-off (~1e-7).
  * ``polyphase_apply`` — the torch form of the traced block matmul, used
    by the fused engine and by ``DeviceChunkResampler``.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable

import numpy as np
import scipy.signal
import torch

from ..ops.mel import fp32_matmul

# 32 zero-crossings per side at the lower rate, Kaiser beta 12.98 (~130 dB
# stopband), 0.947 rolloff
_ZEROS = 32
_BETA = 12.984
_ROLLOFF = 0.9475937167399596


@lru_cache(maxsize=64)
def design_taps(up: int, down: int) -> np.ndarray:
    """Linear-phase low-pass FIR for a rational up/down conversion
    (unscaled: resample_poly multiplies by ``up``)."""
    max_rate = max(up, down)
    f_c = _ROLLOFF / max_rate
    half_len = _ZEROS * max_rate
    return scipy.signal.firwin(2 * half_len + 1, f_c, window=("kaiser", _BETA)).astype(
        np.float64
    )


def _ratio(orig_sr: int, target_sr: int):
    g = math.gcd(int(orig_sr), int(target_sr))
    return target_sr // g, orig_sr // g


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Resample 1-D (or [..., time]) float audio on the host; the output
    length is ``ceil(n * target_sr / orig_sr)`` (librosa's convention)."""
    if orig_sr == target_sr:
        return np.asarray(x, dtype=np.float32)
    up, down = _ratio(orig_sr, target_sr)
    y = scipy.signal.resample_poly(np.asarray(x, dtype=np.float64), up, down,
                                   axis=-1, window=design_taps(up, down))
    return y.astype(np.float32)


def resampled_length(n: int, orig_sr: int, target_sr: int) -> int:
    if orig_sr == target_sr:
        return n
    up, down = _ratio(orig_sr, target_sr)
    return -(-(n * up) // down)  # ceil


def polyphase_matmul_weights(up: int, down: int):
    """The polyphase filter as one dense (width, up) matrix.

    With H = taps·up, half = (T−1)/2 and output m = j·up + q,

        y[m] = Σ_j H[r_q + jj·up] · x[j·down + c_q − jj]
        r_q = (q·down + half) mod up,   c_q = (q·down + half − r_q)/up

    so every block of ``up`` outputs is one matvec against a shared window of
    ``width`` native samples: Y[j, q] = Σ_w W[w, q] · x[j·down + wmin + w].
    Matches scipy.signal.resample_poly.  Returns (W float32, wmin int).
    """
    taps = design_taps(up, down)
    H = (taps * up).astype(np.float64)
    T = len(H)
    half = (T - 1) // 2
    q = np.arange(up, dtype=np.int64)
    r = (q * down + half) % up
    c = (q * down + half - r) // up
    J = (T - 1 - r) // up
    wmin = int((c - J).min())
    wmax = int(c.max())
    width = wmax - wmin + 1
    W = np.zeros((width, up), np.float64)
    for qq in range(up):
        jj = np.arange(J[qq] + 1)
        W[c[qq] - jj - wmin, qq] = H[r[qq] + jj * up]
    return W.astype(np.float32), wmin


def polyphase_block_geometry(up: int, down: int, out_chunk: int):
    """(W, wmin, n_blocks, n_copies, pad_l, in_len) for a chunk of
    ``out_chunk`` outputs: output block j is X[j] @ W with
    X[j] = xp[base + j·down : … + width], assembled from ``n_copies``
    shifted views of a (n_blocks+n_copies, down) reshape."""
    W, wmin = polyphase_matmul_weights(up, down)
    width = W.shape[0]
    n_blocks = -(-out_chunk // up) + 5  # slack: alignment lo can reach ~4·up
    n_copies = -(-width // down) + 1
    pad_l = max(0, -wmin)
    in_len = (n_blocks + n_copies) * down + pad_l + width
    return W, wmin, n_blocks, n_copies, pad_l, in_len


def polyphase_apply(x: torch.Tensor, W: torch.Tensor, *, wmin: int, pad_l: int,
                    n_blocks: int, n_copies: int, down: int,
                    width: int) -> torch.Tensor:
    """Resample the padded native buffer ``x`` (laid out by
    polyphase_block_geometry) → flat internal-rate samples.

    The product runs in true float32 with TF32 off: audio samples need it,
    as the reference pins HIGHEST (its ``resample.py:153-169``).
    """
    base = wmin + pad_l
    n = (n_blocks + n_copies) * down
    if base < 0 or base + n > x.shape[0]:
        raise ValueError("polyphase buffer too short for its geometry")
    A = x[base: base + n].reshape(n_blocks + n_copies, down)
    X = torch.cat([A[k: k + n_blocks] for k in range(n_copies)], dim=1)[:, :width]
    with fp32_matmul():
        Y = X @ W
    return Y.reshape(-1)


@lru_cache(maxsize=16)
def get_device_resampler(orig_sr: int, target_sr: int, out_chunk: int,
                         device: torch.device) -> "DeviceChunkResampler":
    """The DeviceChunkResampler for these rates and chunk on ``device``,
    built once (its filter matrix is uploaded once)."""
    return DeviceChunkResampler(orig_sr, target_sr, out_chunk, device)


class DeviceChunkResampler:
    """Fixed-geometry device resampler for the host pipeline's streaming
    decode: per chunk, one upload of the native range, one polyphase GEMM
    on ``device`` and one fetch.

    Alignment contract: the native read starts at a multiple of ``down``,
    so chunk outputs land exactly on the whole-file resampling grid (the
    host chunk path's invariant).  Each call fills a fresh buffer, so one
    instance may serve several streams.
    """

    def __init__(self, orig_sr: int, target_sr: int, out_chunk: int,
                 device: torch.device):
        self.orig_sr, self.target_sr = orig_sr, target_sr
        self.up, self.down = _ratio(orig_sr, target_sr)
        self.out_chunk = out_chunk
        self.device = torch.device(device)
        (W, self.wmin, self.n_blocks, self.n_copies,
         self.pad_l, self.in_len) = polyphase_block_geometry(self.up, self.down, out_chunk)
        self.width = W.shape[0]
        self.W = torch.from_numpy(W).to(self.device)

    def resample_range(self, read_native: Callable[[int, int], np.ndarray],
                       native_frames: int, out_pos: int, out_n: int) -> np.ndarray:
        """Internal-rate samples [out_pos, out_pos + out_n).

        ``read_native(start, frames)`` returns float32 mono native samples,
        clamped at EOF; the zero fill at the edges matches the whole-file
        resample's zero padding.
        """
        if out_n > self.out_chunk:
            raise ValueError(f"out_n={out_n} exceeds the chunk of {self.out_chunk}")
        up, down = self.up, self.down
        # read from rs (a multiple of down), block 0 of a local grid whose
        # first output is global index rs·up/down
        rs = max(0, (out_pos * down) // up - 2 * down)
        rs -= rs % down
        lo = out_pos - (rs * up) // down
        # RuntimeError, not assert: these guard against silently
        # time-shifted audio and must survive python -O
        if not 0 <= lo <= 4 * up:
            raise RuntimeError(f"polyphase alignment violated: lo={lo} up={up}")
        if lo + out_n > self.n_blocks * up:
            raise RuntimeError(f"polyphase range violated: lo={lo} out_n={out_n} "
                               f"cap={self.n_blocks * up}")
        cuda = self.device.type == "cuda"
        host = torch.zeros(self.in_len, dtype=torch.float32, pin_memory=cuda)
        # native sample rs + i sits at pad_l + i; the filter's left context
        # (indices below rs) is real audio too
        left = min(rs, self.pad_l)
        re = min(native_frames, rs + self.in_len - self.pad_l)
        got = read_native(rs - left, re - (rs - left))
        host.numpy()[self.pad_l - left: self.pad_l - left + len(got)] = got
        y = polyphase_apply(host.to(self.device, non_blocking=True), self.W,
                            wmin=self.wmin, pad_l=self.pad_l, n_blocks=self.n_blocks,
                            n_copies=self.n_copies, down=down, width=self.width)
        return y[lo: lo + out_n].cpu().numpy()
