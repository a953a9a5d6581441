"""Training-target helpers (a copy of the JAX package's ``train/targets.py``).

Parity with the reference's latent training code:
  * ``process_spec``       — voice_activity.py:918-930: fixed −80/80 dB
    scaling into [0,1], trim to 256×256, zero out all-ones (silence) specs
  * ``frame_mask``         — voice_activity.py:933-943 (generate_1D_mask):
    1.0 where any frequency bin in the column is nonzero
"""

from __future__ import annotations

import numpy as np
import torch


def process_spec(spec: np.ndarray) -> np.ndarray:
    """dB spectrogram → [0,1]-scaled 256×256 training image."""
    spec = (np.asarray(spec, np.float32) + 80.0) / 80.0
    spec = spec[0:256, 2:-1]
    spec = spec[..., None]
    if spec.sum() == 256 * 256:  # pure-silence sentinel
        spec = np.zeros_like(spec)
    return spec


def frame_mask(spec: torch.Tensor) -> torch.Tensor:
    """(…, F, T) spec → (…, T) float32 mask: any-nonzero per time column."""
    return (torch.as_tensor(spec) != 0).any(dim=-2).to(torch.float32)


def frame_mask_np(spec: np.ndarray) -> np.ndarray:
    return np.any(np.asarray(spec) != 0, axis=-2).astype(np.float32)
