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
