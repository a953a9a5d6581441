"""Frontend ops and the hand-written CUDA kernels.

``KERNEL_LAUNCHES`` counts, per kernel name, the launches each wrapper made:
a wrapper adds one (``count_launch``) where it launches its kernel and
nowhere else, so a run can show that the main path went through the kernels.
"""

import threading
from collections import Counter

KERNEL_LAUNCHES: Counter = Counter()
_launch_lock = threading.Lock()


def count_launch(name: str) -> None:
    """One launch of kernel ``name``; safe when files detect on several
    threads at once."""
    with _launch_lock:
        KERNEL_LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    with _launch_lock:
        KERNEL_LAUNCHES.clear()


# the JAX package's public frontend functions (after the counters: the
# kernel wrappers import ``count_launch`` from here)
from .mel import (  # noqa: E402
    frame_index_table,
    gather_frames,
    log_mel_clips,
    log_mel_from_frames,
    log_mel_single,
    log_mel_windows,
    mel_filterbank,
)

__all__ = [
    "KERNEL_LAUNCHES", "count_launch", "reset_launch_counts",
    "frame_index_table", "gather_frames", "log_mel_clips", "log_mel_from_frames",
    "log_mel_single", "log_mel_windows", "mel_filterbank",
]
