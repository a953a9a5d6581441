"""Frozen work counts of SpecUNet_2D detection and training.

Counted from shapes, term for term, as the function's work and not as one
implementation's: a multiply-add is 2 FLOP; BatchNorm, ReLU, pooling and
upsampling are left out (under 1%).  The mel frontend counts the DFT over
the bins that the mel filterbank weighs (``MEL_BINS``) and the filterbank's
nonzero weights (``FB_NONZERO``), whatever a kernel pads them to.

``windows(frames, sample_rate)`` is the number of 3 s windows the reference
algorithm evaluates for a file: the file is zero-padded by 3 s on each side
at its own rate, resampled to 22,050 Hz, and windowed every 13,230 samples.
"""

from __future__ import annotations

import math

SR = 22050
WINDOW = 66150
STEP = 13230
PAD_S = 3.0
FRAMES = 256
WIN = 512
N_MELS = 128
MEL_BINS = 744        # DFT bins 0..743 carry weight below f_max = 8 kHz
FB_NONZERO = 1469     # nonzero weights of the (1025, 128) HTK filterbank

# (h, w, cin, cout) of every residual block on the mask path
_BLOCKS_2D = (
    (128, 256, 1, 32), (64, 128, 32, 64), (32, 64, 64, 96), (16, 32, 96, 128),
    (8, 16, 128, 128), (8, 16, 128, 128),
    (16, 32, 256, 96), (32, 64, 192, 64), (64, 128, 128, 32), (128, 256, 64, 32),
)
_SPEC_BLOCK = (128, 256, 32, 32)


def _res2d(h, w, cin, cout) -> float:
    return 2.0 * h * w * (cin * cout + 9 * cin * cout + 9 * cout * cout)


def mel_flops_per_frame() -> float:
    """DFT (cos and sin) + power + mel product + sqrt(log10(x + 1))."""
    return 2.0 * WIN * 2 * MEL_BINS + 3.0 * MEL_BINS + 2.0 * FB_NONZERO + 3.0 * N_MELS


def mel_flops_per_window() -> float:
    return FRAMES * mel_flops_per_frame()


def mask_head_flops() -> float:
    flat = 2.0 * FRAMES * (N_MELS * 32) * 4
    block1d = 2.0 * FRAMES * (4 * 4 + 3 * 4 * 4 + 3 * 4 * 4)
    return flat + block1d + 2.0 * FRAMES * 4


def unet_flops_per_window(spec_head: bool = False) -> float:
    f = sum(_res2d(*b) for b in _BLOCKS_2D) + mask_head_flops()
    if spec_head:
        f += _res2d(*_SPEC_BLOCK) + 2.0 * 128 * 256 * 32 * 2
    return f


def detect_flops_per_window() -> float:
    """Forward work of one detection window: frontend + U-Net mask path."""
    return mel_flops_per_window() + unet_flops_per_window()


def train_flops_per_clip() -> float:
    """One training clip: 3 x the forward with both heads (forward and
    backward), plus the two extra frontends of the speech and noise
    targets."""
    return 3.0 * (mel_flops_per_window() + unet_flops_per_window(spec_head=True)) \
        + 2.0 * mel_flops_per_window()


def windows(frames: int, sample_rate: int) -> int:
    pad = int(round(PAD_S * sample_rate))
    g = math.gcd(int(sample_rate), SR)
    up, down = SR // g, int(sample_rate) // g
    n = frames + 2 * pad
    padded = -(-n * up // down) if sample_rate != SR else n
    return max(0, math.ceil((padded - WINDOW) / STEP))
