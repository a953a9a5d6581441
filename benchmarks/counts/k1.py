"""Frozen count of the work of one call of K1, the framing + DFT + mel
kernel (``ops/frame_mel.py`` -> ``csrc/frame_mel.cu``).

K1 turns B windows of a chunk buffer into B log-mel images.  Its work is
counted as the function's: ``specunet2d.mel_flops_per_frame`` for each of
the B x 256 frames; each input byte read once (the float32 samples the B
windows span, 13,230 apart, and the B int32 starts) and each output byte
written once (B x 128 x 256 values of ``out_bytes``).  The peaks are the
H100 SXM data sheet's dense bf16 rate and HBM3 bandwidth.
"""

from __future__ import annotations

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "_bench_counts_specunet2d", os.path.join(os.path.dirname(__file__), "specunet2d.py"))
S = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(S)

KERNEL_NAME_PARTS = ("mel_core_kernel", "WindowLoader")
PEAK_FLOPS = 989.4e12
PEAK_BYTES_PER_S = 3.35e12


def flops(batch: int) -> float:
    return batch * S.FRAMES * S.mel_flops_per_frame()


def bytes_moved(batch: int, out_bytes: int = 2) -> float:
    span = (batch - 1) * S.STEP + S.WINDOW
    return 4.0 * span + 4.0 * batch + out_bytes * batch * S.N_MELS * S.FRAMES


def least_seconds(batch: int, out_bytes: int = 2) -> float:
    """The least time one call can take on the card: the larger of its
    operations over the peak rate and its bytes over the bandwidth."""
    return max(flops(batch) / PEAK_FLOPS, bytes_moved(batch, out_bytes) / PEAK_BYTES_PER_S)
