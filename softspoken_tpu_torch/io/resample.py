"""Polyphase sample-rate conversion as one dense matrix product.

Same filter and geometry as the JAX package's ``io/resample.py`` (a
Kaiser-windowed-sinc design comparable to librosa's kaiser_best, standing in
for the reference's soxr resampler, ``voice_activity.py:65-67``): the numpy
and scipy helpers below are copies, and ``polyphase_apply`` is the torch form
of the traced block matmul.
"""

from __future__ import annotations

import math
from functools import lru_cache

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
