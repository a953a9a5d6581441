"""The plain detection chain for one WAV file.

WAV decode (``audio.read_wav``) -> /32768 -> 3 s of zeros on each side at
the file's own rate -> resampling to 22,050 Hz (``audio.resample``) ->
3 s windows every 0.6 s -> log-mel (``mel.LogMel``) -> SpecUNet_2D's mask
logits (``specunet.mask_logits``) -> the averaged grid and its regions
(``grid``).  Float32 on ``device`` with TF32 off for matmuls and cuDNN;
``precision="fp8"`` is the control (``quant.py``).  Imports nothing of
the program.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from . import audio, grid, mel, quant, specunet

SR = 22050
WINDOW = 66150
STEP = 13230
PAD_S = 3.0


@contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@dataclass
class Detection:
    grid: np.ndarray                         # float64 mean logit per bin
    intervals: List[Tuple[float, float]]     # seconds, pad-shifted


def internal_wave(path: str) -> np.ndarray:
    """The padded stream at 22,050 Hz, float32."""
    pcm, sr = audio.read_wav(path)
    pad = int(round(PAD_S * sr))
    x = np.concatenate([np.zeros(pad), pcm.astype(np.float64) / 32768.0, np.zeros(pad)])
    return audio.resample(x, sr, SR).astype(np.float32)


class Detector:
    """The reference detector on ``device`` with the ``.pth`` weights."""

    def __init__(self, weights_path: str, device, precision: str = "float32",
                 batch: int = 64):
        self.device = torch.device(device)
        self.q = quant.PRECISIONS[precision]
        self.sd = specunet.load_state(weights_path, self.device)
        self.mel = mel.LogMel(self.device, self.q)
        self.batch = batch

    @torch.no_grad()
    def logits(self, wave: np.ndarray) -> np.ndarray:
        n = math.ceil((len(wave) - WINDOW) / STEP)
        x = torch.from_numpy(wave).to(self.device)
        out = []
        with no_tf32():
            for b0 in range(0, n, self.batch):
                starts = torch.arange(b0, min(n, b0 + self.batch), device=self.device) * STEP
                win = x[starts[:, None] + torch.arange(WINDOW, device=self.device)[None, :]]
                m = self.mel(win)
                if self.q is not None:
                    m = self.q(m)
                out.append(specunet.mask_logits(m, self.sd, self.q).cpu())
        return torch.cat(out).double().numpy()

    def detect_wave(self, wave: np.ndarray) -> Detection:
        avg = grid.average(self.logits(wave))
        return Detection(avg, grid.regions(avg))

    def detect(self, path: str) -> Detection:
        return self.detect_wave(internal_wave(path))
