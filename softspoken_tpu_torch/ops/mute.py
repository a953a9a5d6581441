"""Interval → mute-gain application (the "Silence Voices" step).

A copy of the JAX package's ``ops/mute.py``.  The reference hard-zeroes
``audio[:, round(st*sr):round(et*sr)] = 0`` row by row in Python
(``silencer_ui.py:974-985``).  Here the intervals become one gain vector
applied in a single vectorized pass:

  * gain construction is O(N) via a delta/cumsum coverage count — robust to
    overlapping intervals;
  * "zero" mode reproduces the reference exactly (round-half-even sample
    indices, hard cut);
  * "crossfade" mode adds linear ramps of ``fade_samples`` on both sides of
    every muted span (the reference has no crossfade);
  * ``apply_mute_device`` runs the same math in torch on the CUDA card (the
    JAX package's ``jax_apply_mute``) for device-resident audio.

The silencer calls the numpy ``apply_mute``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def interval_samples(
    intervals: Sequence[Tuple[float, float]], sr: int, n: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Seconds → clamped sample index pairs, reference rounding
    (int(round(t*sr)) with half-even, silencer_ui.py:977-982)."""
    if len(intervals) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    arr = np.asarray(intervals, np.float64)
    starts = np.rint(arr[:, 0] * sr).astype(np.int64).clip(0, n)
    ends = np.rint(arr[:, 1] * sr).astype(np.int64).clip(0, n)
    # a degenerate end<start interval must no-op (as the reference's
    # audio[st:et]=0 does) — unclamped it would subtract coverage BEFORE
    # its start, cancelling a valid overlapping interval's mute
    ends = np.maximum(ends, starts)
    return starts, ends


def mute_gain(
    n: int,
    starts: np.ndarray,
    ends: np.ndarray,
    fade_samples: int = 0,
) -> np.ndarray:
    """Per-sample gain in [0,1]: 0 inside muted spans, ramps at the edges."""
    cover = np.zeros(n + 1, np.int64)
    np.add.at(cover, starts, 1)
    np.add.at(cover, ends, -1)
    muted = np.cumsum(cover[:-1]) > 0
    gain = np.where(muted, 0.0, 1.0).astype(np.float32)
    if fade_samples > 0 and muted.any():
        ramp_out = np.linspace(1.0, 0.0, fade_samples, endpoint=False, dtype=np.float32)
        ramp_in = ramp_out[::-1]
        d = np.diff(muted.astype(np.int8))
        for s in np.flatnonzero(d == 1) + 1:      # silence begins at s
            lo = max(0, s - fade_samples)
            seg = ramp_out[fade_samples - (s - lo) :]
            gain[lo:s] = np.minimum(gain[lo:s], seg)
        for e in np.flatnonzero(d == -1) + 1:     # silence ends at e
            hi = min(n, e + fade_samples)
            seg = ramp_in[: hi - e]
            gain[e:hi] = np.minimum(gain[e:hi], seg)
    return gain


def apply_mute(
    audio: np.ndarray,
    intervals: Sequence[Tuple[float, float]],
    sr: int,
    fade_samples: int = 0,
    offset: int = 0,
    total_samples: int = None,
) -> np.ndarray:
    """Mute intervals in (channels, samples) or (samples,) float audio.

    ``offset`` is the absolute sample index of audio[...,0] and
    ``total_samples`` the full stream length — streaming callers apply
    global intervals chunk by chunk with results identical to a whole-file
    pass (ramps that straddle a chunk border are split consistently because
    edge positions are global).

    Ownership: when no interval touches the chunk the INPUT ARRAY is
    returned aliased (no copy) — treat the result as read-only, or copy
    before mutating in place.
    """
    n = audio.shape[-1]
    if total_samples is None:
        total_samples = offset + n
    starts, ends = interval_samples(intervals, sr, total_samples)
    starts = starts - offset
    ends = ends - offset
    # keep intervals whose mute-or-ramp region touches this chunk
    keep = (ends > -fade_samples) & (starts < n + fade_samples)
    starts, ends = starts[keep], ends[keep]
    if len(starts) == 0:
        return audio
    # work in a padded coordinate frame so out-of-chunk edges stay distinct
    pad = fade_samples + 1
    starts = np.clip(starts + pad, 0, n + 2 * pad)
    ends = np.clip(ends + pad, 0, n + 2 * pad)
    g = mute_gain(n + 2 * pad, starts, ends, fade_samples)[pad : pad + n]
    return (audio * g).astype(audio.dtype, copy=False)


def apply_mute_device(audio, starts, ends, fade_samples: int = 0, device=None):
    """Device twin of ``apply_mute``: (C, N) float audio, int sample intervals.

    Runs on the CUDA card unless ``device`` names another (``"cpu"``); the
    result is a tensor on that device.  Hard zero when ``fade_samples == 0``;
    linear crossfade otherwise, computed as distance-to-muted-span ramps.
    Branch-free like the JAX version: a ``scatter_add_`` and an int32
    ``cumsum`` for the coverage count, ``cummax`` from the left and a
    flipped ``cummin`` from the right for the distances.
    """
    import torch

    from ..engine.detector import resolve_device

    dev = resolve_device(device)
    audio = torch.as_tensor(audio, device=dev)
    n = audio.shape[-1]
    starts = torch.as_tensor(starts, device=dev).to(torch.int64).clamp(0, n)
    # same degenerate-interval guard as interval_samples: end < start must
    # no-op, not cancel another interval's coverage
    ends = torch.maximum(torch.as_tensor(ends, device=dev).to(torch.int64).clamp(0, n),
                         starts)
    cover = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    cover.scatter_add_(0, starts, torch.ones_like(starts, dtype=torch.int32))
    cover.scatter_add_(0, ends, torch.full_like(ends, -1, dtype=torch.int32))
    muted = torch.cumsum(cover[:-1], 0, dtype=torch.int32) > 0
    if fade_samples == 0:
        return audio * (1.0 - muted.to(audio.dtype))
    # distance (in samples) to the nearest muted sample, both directions
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    big = n + fade_samples
    last_mut_left = torch.cummax(
        torch.where(muted, idx, torch.full_like(idx, -big)), 0).values
    first_mut_right = torch.flip(torch.cummin(torch.flip(
        torch.where(muted, idx, torch.full_like(idx, big * 2)), (0,)), 0).values, (0,))
    dist = torch.minimum(idx - last_mut_left, first_mut_right - idx)
    gain = torch.clamp(dist.to(audio.dtype) / float(fade_samples), 0.0, 1.0)
    return audio * gain
