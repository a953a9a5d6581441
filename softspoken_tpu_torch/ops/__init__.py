"""Frontend ops and the hand-written CUDA kernels.

``KERNEL_LAUNCHES`` counts, per kernel name, the launches each wrapper made:
a wrapper adds one where it launches its kernel and nowhere else, so a run
can show that the main path went through the kernels.
"""

from collections import Counter

KERNEL_LAUNCHES: Counter = Counter()


def reset_launch_counts() -> None:
    KERNEL_LAUNCHES.clear()
