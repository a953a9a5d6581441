"""Device meshes and window-sharded detection (the JAX package's
``parallel/mesh.py``).

A ``Mesh`` is an array of ``torch.device`` entries with named axes.  For
detection, ``MeshDetector`` shards each batch of windows over the mesh's
``data`` axis, as the JAX package does: one host thread drives every card's
stream, each ``data`` entry holds its own replica of the folded model, and
no collective runs on the detect path.  Per chunk the wave the windows read
(the fused engine's resampled ``internal`` buffer, or the host pipeline's
uploaded chunk) is copied once from the detector's card to every other
card of the axis: the JAX program replicates the native chunk and decodes
and resamples it on every chip, which computes the same values at more
cost.  Each batch's window starts split into ``data`` contiguous shards,
shard k on entry k; the logits come back to the detector's card in shard
order, where the grid is updated as on one card.  Per-window logits do not
depend on the sharding, so the grid differs from one card's only where a
convolution's algorithm choice for the smaller batch rounds differently.

A device may be listed more than once: ``make_mesh(devices=["cpu"] * 4)``
is the stand-in for four cards in the CPU tests, as the JAX tests use eight
virtual CPU devices.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """``devices`` (an object array of ``torch.device``, shape ``shape``)
    with one name per axis."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} needs {devices.ndim} "
                             f"axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis``, at index 0 of every other axis."""
        i = self.axis_names.index(axis)
        index = tuple(slice(None) if j == i else 0 for j in range(self.devices.ndim))
        return list(self.devices[index])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(axis_names: Tuple[str, ...] = ("data",),
              shape: Optional[Tuple[int, ...]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA card), shaped
    ``shape`` (default: all devices on the first axis).  Raises when no
    card is visible and no devices were passed: the CPU is used only when
    the caller names it."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= "
                               "(e.g. ['cpu'] * n) to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = [torch.device(d) for d in devices]
    if shape is None:
        shape = (len(devs),) + (1,) * (len(axis_names) - 1)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axis_names)


class _ShardedForward:
    """``fn(wave, starts (nb, B)) -> logits (nb·B, 256)`` on the detector's
    device, each batch's windows split over the mesh's ``data`` axis."""

    def __init__(self, detector, mesh: Mesh):
        self.det = detector
        self.devices = mesh.axis_devices("data")
        # one replica per entry, even where a device repeats; each carries
        # the detector's channels-last plan (models/unet.py), as it lies
        self.models = [copy.deepcopy(detector.model).to(d) for d in self.devices]

    def __call__(self, wave: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        det, n = self.det, len(self.devices)
        nb, B = starts.shape
        per = B // n
        waves = {wave.device: wave}
        shards = []
        for k, (dev, model) in enumerate(zip(self.devices, self.models)):
            if dev not in waves:  # one copy of the chunk per card
                waves[dev] = wave.to(dev, non_blocking=True)
            st = starts[:, k * per: (k + 1) * per].to(dev, non_blocking=True)
            shards.append(torch.stack([det._forward(waves[dev], st[i], model)
                                       for i in range(nb)]))      # (nb, per, 256)
        # every card's work is queued before the first result is gathered
        out = torch.cat([s.to(det.device) for s in shards], dim=1)
        return out.reshape(nb * B, out.shape[-1])


def shard_windows_forward(detector, mesh: Mesh):
    """The detector's chunk forward with each batch's windows sharded over
    ``mesh``'s ``data`` axis: ``fn(wave, starts (nb, B)) -> (nb·B, 256)``.
    ``B`` must be a multiple of the data-axis size."""
    return _ShardedForward(detector, mesh)


class MeshDetector:
    """Drop-in multi-card wrapper: the ``Detector`` surface, windows sharded
    over the mesh's ``data`` axis in the fused and the host pipeline.  It
    reroutes the wrapped detector itself (its ``_forward_chunk`` and
    ``_fused_mesh``); ``restore()`` or leaving the ``with`` block undoes
    that."""

    def __init__(self, detector, mesh: Optional[Mesh] = None):
        if getattr(detector, "_fused_mesh", None) is not None:
            raise RuntimeError(
                "detector is already mesh-bound (wrapped by a MeshDetector "
                "that has not been restore()d); nest wrappers LIFO or "
                "restore the existing one first")
        self.det = detector
        self.mesh = mesh if mesh is not None else make_mesh()
        sizes = self.mesh.shape
        if "data" not in sizes:
            raise ValueError(
                f"mesh has no 'data' axis (axes: {self.mesh.axis_names}); "
                "shard_windows_forward shards windows over 'data'")
        n = sizes["data"]
        if detector.cfg.engine.device_batch % n:
            raise ValueError(
                f"device_batch ({detector.cfg.engine.device_batch}) must be a "
                f"multiple of the mesh 'data' axis size ({n})")
        detector._forward_chunk = shard_windows_forward(detector, self.mesh)
        detector._fused_mesh = self.mesh
        self._bound = True

    def restore(self) -> None:
        """Put the wrapped detector back on its single-device forward
        (idempotent)."""
        if not self._bound:
            return
        del self.det._forward_chunk  # the class's method shows again
        self.det._fused_mesh = None
        self._bound = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.restore()

    def __getattr__(self, name):
        return getattr(self.det, name)
