"""softspoken_tpu_torch — the speech detector on PyTorch and CUDA.

A port of ``softspoken_tpu`` (JAX) that imports nothing of it.  Entry
points run on the CUDA card unless the caller asks for the CPU.
"""

from .config import Config, DEFAULT_CONFIG, parity_config

__all__ = ["Config", "DEFAULT_CONFIG", "parity_config"]
