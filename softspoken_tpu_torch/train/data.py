"""Training-clip assembly from recordings (the JAX package's
``train/data.py``): the reference's data loaders, rebuilt, and the batch
builder of the host trainer (``train/fit.py::fit``).

Parity targets (voice_activity.py):
  * load_environmental_noise (:256-269) — a 3 s noise clip starting at a
    given internal-rate offset, tiled when shorter than 3 s
  * load_peoples_speech      (:274-282) — sum several 3 s speech reads into
    one clip
  * load_spoken_word         (:285-297) — place whole short recordings at
    given offsets inside a 3 s clip

``build_batch`` mixes speech and noise at a random SNR in numpy (the JAX
package's arithmetic and draws), then augments and computes the mels on the
device:
  clean speech  → mel target channel 0, frame mask from the clean mel
  environment   → mel target channel 1
  model input   → mel of the augmented speech+environment mix
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DEFAULT_CONFIG
from ..engine.detector import resolve_device
from ..io import load_audio
from ..ops import mel as melops
from . import augment as aug
from .targets import frame_mask

SR = DEFAULT_CONFIG.dsp.sample_rate
CLIP = SR * 3  # 66150


def load_environmental_noise(filename: str, start_idx: int) -> Optional[np.ndarray]:
    """3 s of environmental audio from ``start_idx`` (internal-rate samples);
    clips shorter than 3 s are tiled to fill (voice_activity.py:256-269)."""
    wav, _sr = load_audio(filename, start=start_idx)
    if wav is None or len(wav) == 0:
        return None
    if len(wav) < CLIP:
        wav = np.tile(wav, -(-CLIP // len(wav)))[:CLIP]
    return wav[:CLIP].astype(np.float32)


def load_peoples_speech(filenames: Sequence[Tuple[str, int]]) -> np.ndarray:
    """Sum several (file, start_idx) 3 s reads into one clip (:274-282)."""
    clip = np.zeros(CLIP, np.float32)
    for file_name, start_idx in filenames:
        wav, _sr = load_audio(file_name, start=start_idx)
        if wav is None:
            continue
        n = min(len(wav), CLIP)
        clip[:n] += wav[:n]
    return clip


def load_spoken_word(filenames: Sequence[Tuple[str, int]]) -> np.ndarray:
    """Place whole recordings at sample offsets inside a 3 s clip (:285-297).
    A placement outside the clip is skipped, as the other loaders skip bad
    input."""
    clip = np.zeros(CLIP, np.float32)
    for file_name, start_idx in filenames:
        wav, _sr = load_audio(file_name)
        if wav is None or not 0 <= start_idx < CLIP:
            continue
        end = min(start_idx + len(wav), CLIP)
        clip[start_idx:end] = wav[: end - start_idx]
    return clip


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_batch(
    speech_clips: np.ndarray,
    noise_clips: np.ndarray,
    rng: np.random.Generator,
    augmentations: Sequence[str] = (),
    snr_db_range: Tuple[float, float] = (-5.0, 20.0),
    device=None,
    mel_mode: Optional[str] = None,
    timings: Optional[Dict[str, float]] = None,
    rows: slice = slice(None),
) -> Dict[str, torch.Tensor]:
    """Compose (B, 66150) speech + noise into a training batch on ``device``
    (the CUDA card unless the caller passes ``"cpu"``).

    Returns {"mel": (B, 128, 256), "mask": (B, 256), "spec": (B, 2, 128,
    256)}, the layout ``loop.train_step`` takes: the spec target stacks the
    clean speech and environment mels (the model's two separation channels,
    pytorch_neural_nets.py:126-130), and the frame mask is any speech energy
    per frame of the clean mel (voice_activity.py:933-943).

    The SNR draw and the mix are the JAX package's numpy code, and ``rng``
    advances as there: with augmentations, one ``rng.integers(0, 2**31 - 1)``
    per row seeds that row's ``torch.Generator`` (a CPU one, so a seed gives
    the same parameters on every device), and each row is augmented with its
    own parameters.  ``mel_mode`` defaults to ``ops.mel.train_mel_mode``.
    ``timings``, when given, receives the seconds spent augmenting ("augment")
    and computing the mels ("mel"), the device synchronized at each boundary.
    ``rows`` picks the rows to build (a shard of mesh training): every draw
    is made for the whole batch, the augmentation and the mels only for
    these rows, which the returned batch holds.
    """
    dev = resolve_device(device)
    B = speech_clips.shape[0]
    assert noise_clips.shape[0] == B

    # SNR mixing
    snr_db = rng.uniform(*snr_db_range, size=(B, 1)).astype(np.float32)
    sp_rms = np.sqrt(np.mean(speech_clips**2, axis=1, keepdims=True) + 1e-12)
    nz_rms = np.sqrt(np.mean(noise_clips**2, axis=1, keepdims=True) + 1e-12)
    gain = sp_rms / (nz_rms * 10.0 ** (snr_db / 20.0))
    noise_scaled = noise_clips * gain
    mix = speech_clips + noise_scaled

    def upload(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x[rows], np.float32)).to(dev)

    t0 = time.perf_counter()
    mix_t = upload(mix)
    if augmentations:
        # per-clip parameter draws (the reference's semantics, and the device
        # trainer's): one draw for the whole batch would give every row the
        # same reverb, band-pass and volume
        own = range(B)[rows]
        built = []
        for b in range(B):
            seed = int(rng.integers(0, 2**31 - 1))  # every row's draw, built or not
            if b not in own:
                continue
            gen = torch.Generator()
            gen.manual_seed(seed)
            params = aug.get_parameters(gen, augmentations)
            i = b - own.start
            built.append(aug.apply_augmentations(mix_t[i: i + 1], SR, augmentations, params))
        mix_t = torch.cat(built, dim=0)
    if timings is not None:
        _sync(dev)
        t1 = time.perf_counter()
        timings["augment"] = timings.get("augment", 0.0) + t1 - t0
        t0 = t1

    mode = mel_mode or melops.train_mel_mode(dev)
    mel_mix = melops.log_mel_clips(mix_t, mode)
    mel_speech = melops.log_mel_clips(upload(speech_clips), mode)
    mel_noise = melops.log_mel_clips(upload(noise_scaled), mode)
    # the frame mask from clean-speech energy (a tiny numeric floor: the
    # log-mel of silence is exactly 0)
    mask = frame_mask(torch.where(mel_speech > 1e-4, mel_speech, 0.0))
    if timings is not None:
        _sync(dev)
        timings["mel"] = timings.get("mel", 0.0) + time.perf_counter() - t0
    return {"mel": mel_mix, "mask": mask,
            "spec": torch.stack([mel_speech, mel_noise], dim=1)}
