"""The detector: weights, numerics and the batched mel + U-Net forward.

Reference behaviour (not its structure):
  * NNDetector.__init__/load_checkpoint  — NNDetector.py:21-53
  * process_batch (3 s slices → model)   — NNDetector.py:84-101

Numerics.  "parity": float32 everywhere with TF32 off and the mel DFT in
float32 ("highest") through the plain torch chain.  "fast": bfloat16 convs
with float32 accumulation, and the mel frontend through the hand-written
CUDA kernel (``ops/frame_mel.py``) with a one-pass bf16 DFT ("default")
and bf16 output.  ``mel_kernel`` / ``mel_precision`` pin either explicitly.

The detection path computes the mask head only (``SpecUNet2D.mask_logits``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import ckpt as ckpt_mod
from ..config import Config, DEFAULT_CONFIG
from ..models import build_model
from ..ops import mel as melops

log = logging.getLogger(__name__)


def resolve_device(device=None) -> torch.device:
    """``None`` → the CUDA card; raises when there is none.  Pass
    ``device="cpu"`` explicitly to run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: softspoken_tpu_torch runs on the GPU by default; "
                "pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


@dataclasses.dataclass
class DetectionResult:
    """Per-file detection output (times already −pad-shifted, seconds)."""

    intervals: List[Tuple[float, float]]
    avg_values: np.ndarray          # averaged raw logits per covered grid bin
    num_windows: int
    audio_seconds: float            # unpadded duration of the input


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to softspoken_tpu_torch yet "
                               "(see ROADMAP.md)")


class Detector:
    """Sliding-window speech detector over the mel + U-Net forward."""

    def __init__(
        self,
        config: Config = DEFAULT_CONFIG,
        state_dict: Optional[Mapping[str, object]] = None,
        checkpoint_path: Optional[str] = None,
        fold: bool = True,
        device=None,
    ):
        self.cfg = config
        self.device = resolve_device(device)
        self.epoch = -1
        eng = config.engine
        if eng.music_filter is not None:
            raise _not_ported("the music post-filter (engine.music_filter)")
        if eng.decoder_upsample not in ("auto", "concat"):
            raise _not_ported(f"decoder_upsample={eng.decoder_upsample!r}")
        if eng.conv_impl not in ("auto", "direct"):
            raise _not_ported(f"conv_impl={eng.conv_impl!r}")

        if state_dict is None:
            path = checkpoint_path or os.path.join(
                config.paths.model_dir, config.paths.model_name)
            if os.path.isfile(path):
                state_dict, self.epoch = ckpt_mod.load_pth(path)
            elif os.path.isdir(path):
                raise _not_ported(
                    f"reading orbax checkpoint directories ({path}); export it "
                    "to .pth with the JAX package's convert-ckpt command")
            else:
                # the reference degrades to an untrained model (NNDetector.py:51-53)
                log.warning("no checkpoint found at %s; using random init", path)
                state_dict = ckpt_mod.fixture_state_dict(seed=0)

        self.fast = eng.precision != "parity"
        self.dtype = torch.bfloat16 if self.fast else torch.float32
        self.model = build_model(state_dict, folded=fold).to(
            device=self.device, dtype=self.dtype)

        mp = eng.mel_precision
        if mp == "auto":
            mp = "default" if self.fast else "highest"
        if mp not in melops.MODES:
            raise ValueError(f"unknown mel_precision {mp!r}")
        self.mel_mode = mp
        mk = eng.mel_kernel
        if mk == "auto":
            # parity mode keeps the plain chain: the kernel's summation order
            # differs from it by ~1e-6 (the JAX package's same carve-out)
            mk = "fused" if (self.fast and self.device.type == "cuda") else "xla"
        if mk == "pallas":
            raise _not_ported("mel_kernel='pallas' (the DFT→mel kernel)")
        if mk not in ("fused", "xla"):
            raise ValueError(f"unknown mel_kernel {mk!r}")
        self.mel_kernel = mk
        self._engines: Dict[tuple, object] = {}

    # ------------------------------------------------------------------
    def _forward(self, wave: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        """(chunk_buf,) f32, (B,) int32 on the device → mask logits (B, 256) f32."""
        with torch.inference_mode(), melops.fp32_matmul():
            if self.mel_kernel == "fused":
                from ..ops.frame_mel import log_mel_windows_fused

                mel = log_mel_windows_fused(wave, starts, self.mel_mode,
                                            out_dtype=self.dtype)
            else:
                mel = melops.log_mel_windows(wave, starts, self.mel_mode)
            return self.model.mask_logits(mel)

    def chunk_windows(self) -> int:
        """Windows per chunk: the multiple of device_batch nearest to
        chunk_seconds' window count."""
        cfg = self.cfg
        w = int(cfg.engine.chunk_seconds * cfg.dsp.sample_rate // cfg.samples_per_step)
        B = cfg.engine.device_batch
        return max(B, int(round(w / B)) * B)

    def chunk_buffer_len(self) -> int:
        """Chunk buffer: a chunk's windows + the full last window."""
        cfg = self.cfg
        return (self.chunk_windows() - 1) * cfg.samples_per_step + cfg.samples_per_window

    # ------------------------------------------------------------------
    def detect_file_streaming(
        self, path: str, progress: Optional[Callable[[float], None]] = None,
        journal_dir: Optional[str] = None, timers=None,
    ) -> DetectionResult:
        """Bounded-memory detection of one file through the fused pipeline."""
        pipeline = self.cfg.engine.pipeline
        if pipeline not in ("auto", "fused"):
            raise _not_ported(f"pipeline={pipeline!r} (the host pipeline)")
        return self.detect_file_fused(path, progress, journal_dir, timers=timers)

    def detect_file_fused(
        self, path: str, progress: Optional[Callable[[float], None]] = None,
        journal_dir: Optional[str] = None, timers=None,
    ) -> DetectionResult:
        """Raw PCM to the device; decode, resample, mel, U-Net and the
        overlap grid run there chunk by chunk (engine/fused.py)."""
        from .fused import detect_file_fused

        return detect_file_fused(self, path, progress, journal_dir, timers=timers)
