"""The table stream that ``csrc/mel_core.cuh`` reads, and its inverse.

Both log-mel kernels (``frame_mel``, ``dft_mel``) run the same device core,
which consumes W (the Hann-folded DFT matrix) and fb (the mel filterbank)
as a sequence of 16 KiB bf16 tiles, in exactly the order in which it needs
them, so that its producer thread copies one contiguous tile after another:

    stream[s, t] for bin slice s in 0..11 (64 bins each) and, per slice,
      t = kc * n_parts + p   W part p over samples 64·kc .. 64·kc + 63
                             (kc in 0..7), columns [re 64 | im 64] of the slice
      t = 8 * n_parts + p    fb part p (p in 0..2) over the slice's 64 bins

A tile is (128 output columns, 64 inner values), inner dimension
contiguous (what ``wgmma`` calls K-major), with the 128-byte swizzle of its
shared-memory descriptor already applied: the 16-byte group c of row n is
stored at group ``c ^ (n % 8)``.  The parts are ``ops.mel.bf16_parts``:
n_parts = 1, 2, 3 for the "default", "high" and float32-class DFT products;
fb always has three.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import mel as melops

N_BINS = 768        # mel support ends at bin 743; bins >= 768 weigh exactly 0
SLICE = 64          # bins per slice
N_SLICES = N_BINS // SLICE
CHUNK = 64          # inner values per tile
N_CHUNKS = melops.WIN_LENGTH // CHUNK
FB_PARTS = 3
TILE_ROWS = 2 * SLICE  # = N_MELS = 128


def tiles_per_slice(n_parts: int) -> int:
    return N_CHUNKS * n_parts + FB_PARTS


def _swizzle(tiles: torch.Tensor) -> torch.Tensor:
    """(..., 128, 64) → the same with each row's eight 8-value groups
    permuted by ``c ^ (row % 8)``.  The permutation is its own inverse."""
    rows = torch.arange(TILE_ROWS)[:, None]
    src = torch.arange(8)[None, :] ^ (rows % 8)
    g = tiles.reshape(*tiles.shape[:-1], 8, 8)
    return g[..., rows, src, :].reshape(tiles.shape)


def stream_tables(n_parts: int) -> torch.Tensor:
    """The bf16 tile stream (12, 8·n_parts + 3, 128, 64) on the CPU."""
    if n_parts not in (1, 2, 3):
        raise ValueError(f"n_parts must be 1, 2 or 3, got {n_parts}")
    w, fb = (torch.from_numpy(t) for t in melops.truncated_tables(N_BINS))
    out = torch.empty((N_SLICES, tiles_per_slice(n_parts), TILE_ROWS, CHUNK), dtype=torch.bfloat16)
    for p, part in enumerate(melops.bf16_parts(w, n_parts)):
        # (512, [re|im], 12, 64) → (slice, kc, [re|im]·64, k)
        t = part.reshape(N_CHUNKS, CHUNK, 2, N_SLICES, SLICE).permute(3, 0, 2, 4, 1)
        out[:, p: N_CHUNKS * n_parts: n_parts] = t.reshape(N_SLICES, N_CHUNKS, TILE_ROWS, CHUNK)
    for p, part in enumerate(melops.bf16_parts(fb, FB_PARTS)):
        out[:, N_CHUNKS * n_parts + p] = part.reshape(N_SLICES, SLICE, melops.N_MELS).transpose(1, 2)
    return _swizzle(out).contiguous()


def untile(stream: torch.Tensor, n_parts: int) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Inverse of ``stream_tables``: ([W part (512, 1536)] · n_parts,
    [fb part (768, 128)] · 3) as float32 arrays."""
    t = _swizzle(stream.cpu()).to(torch.float32)
    w_parts = []
    for p in range(n_parts):
        wp = t[:, p: N_CHUNKS * n_parts: n_parts]  # (slice, kc, [re|im]·64, k)
        wp = wp.reshape(N_SLICES, N_CHUNKS, 2, SLICE, CHUNK).permute(1, 4, 2, 0, 3)
        w_parts.append(wp.reshape(melops.WIN_LENGTH, 2 * N_BINS).numpy().copy())
    fb_parts = [t[:, N_CHUNKS * n_parts + p].transpose(1, 2).reshape(N_BINS, melops.N_MELS)
                .numpy().copy() for p in range(FB_PARTS)]
    return w_parts, fb_parts
