"""The process grid of mesh training: one process per ``(data, seq)`` mesh
entry, rank ``d · seq + s``, and the collectives that make a sharded step
compute the unsharded step's result (what GSPMD inserts for the JAX
package's ``make_sharded_train_step``).

* **data**: the batch rows split evenly; the gradients are summed over
  every rank after the backward pass, each rank's loss being its share of
  the global mean, so parameters and AdamW state stay identical on every
  rank.
* **BatchNorm** (training mode) merges every rank's mean and variance,
  gathered with a differentiable all-gather
  (``models/unet.py::_TrainStatsBN``).
* **seq**: the time axis (the last axis of the port's NCHW layout) splits
  into contiguous blocks.  Each kernel-3 convolution first exchanges one
  frame with each neighbour (``halo``, an all-gather of the two edge frames
  over the ``seq`` group; its backward sends each halo's gradient back to
  the frame's owner).  The 2 × 2 pools stay aligned while each block holds
  a multiple of 16 frames; ``conv_flatten`` contracts the mel axis and
  stays local.  The mask logits are gathered over ``seq`` before the loss
  (``gather_seq``): the boundary weights dilate the mask by ±4 frames and
  average each row.

The data axis needs no subgroup of its own: gradients and BatchNorm
statistics reduce over every rank, and only the halo and the logit gather
stay within a ``seq`` group.  Every collective runs in the same order on
every rank (the same graph), in the process group's timeout.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

from .mesh import Mesh


class ProcessGrid:
    """This process's place in a ``(data, seq)`` mesh of processes, and its
    groups.  Needs ``torch.distributed`` initialized with one process per
    mesh entry; every rank must construct it (it makes the subgroups)."""

    def __init__(self, mesh: Mesh):
        if not dist.is_initialized():
            raise RuntimeError(
                "mesh training needs torch.distributed initialized with one process "
                "per mesh entry (train --mesh starts them, or torchrun)")
        sizes = mesh.shape
        if "data" not in sizes or set(sizes) - {"data", "seq"}:
            raise ValueError(f"a training mesh has axes ('data', 'seq'), got {mesh.axis_names}")
        self.data, self.seq = sizes["data"], sizes.get("seq", 1)
        self.world_size = dist.get_world_size()
        if self.world_size != self.data * self.seq:
            raise ValueError(f"mesh {sizes} needs {self.data * self.seq} processes, "
                             f"the process group has {self.world_size}")
        self.rank = dist.get_rank()
        self.d, self.s = divmod(self.rank, self.seq)
        self.device = list(mesh.devices.flat)[self.rank]
        self.world = dist.group.WORLD
        # every rank makes every subgroup, in the same order
        groups = [dist.new_group([d * self.seq + s for s in range(self.seq)])
                  for d in range(self.data)]
        self.seq_group = groups[self.d]

    # -- collectives --------------------------------------------------------
    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable gather over every rank: (...) → (world, ...), rank
        order."""
        return _AllGather.apply(t, self)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over every rank (no gradient)."""
        dist.all_reduce(t, group=self.world)
        return t

    def _seq_all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        out = [torch.empty_like(t) for _ in range(self.seq)]
        dist.all_gather(out, t.contiguous(), group=self.seq_group)
        return out

    def halo(self, x: torch.Tensor) -> torch.Tensor:
        """(..., W) → (..., W + 2): the left neighbour's last frame, x, the
        right neighbour's first frame (zeros past either end)."""
        return _Halo.apply(x, self)

    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """(..., W) → (..., seq · W): the seq group's blocks in order."""
        return _GatherSeq.apply(x, self)

    def all_reduce_grads(self, params) -> None:
        """Sum every parameter's gradient over every rank, in one
        all-reduce."""
        params = [p for p in params if p.requires_grad]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        flat = self.sum_(torch.cat([g.reshape(-1) for g in grads]))
        at = 0
        for p, g in zip(params, grads):
            n = g.numel()
            p.grad = flat[at: at + n].view_as(p).clone()
            at += n


class _AllGather(torch.autograd.Function):
    """An all-gather whose gradient is this rank's slot of the summed
    gradients: every rank's loss reads every slot.
    (``torch.distributed.nn.functional``'s is deprecated from torch 2.13.)"""

    @staticmethod
    def forward(ctx, t: torch.Tensor, grid: ProcessGrid) -> torch.Tensor:
        ctx.grid = grid
        out = [torch.empty_like(t) for _ in range(grid.world_size)]
        dist.all_gather(out, t.contiguous(), group=grid.world)
        return torch.stack(out)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return ctx.grid.sum_(g.contiguous().clone())[ctx.grid.rank], None


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, grid: ProcessGrid) -> torch.Tensor:
        ctx.grid = grid
        got = grid._seq_all_gather(torch.cat([x[..., :1], x[..., -1:]], dim=-1))
        zero = torch.zeros_like(x[..., :1])
        s = grid.s
        left = got[s - 1][..., 1:] if s > 0 else zero
        right = got[s + 1][..., :1] if s + 1 < grid.seq else zero
        return torch.cat([left, x, right], dim=-1)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        grid, s = ctx.grid, ctx.grid.s
        # g's first and last frames belong to the neighbours' edge frames
        got = grid._seq_all_gather(torch.cat([g[..., :1], g[..., -1:]], dim=-1))
        dx = g[..., 1:-1].clone()
        if s > 0:  # the left neighbour's right halo is this rank's first frame
            dx[..., :1] += got[s - 1][..., 1:]
        if s + 1 < grid.seq:
            dx[..., -1:] += got[s + 1][..., :1]
        return dx, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, grid: ProcessGrid) -> torch.Tensor:
        ctx.grid, ctx.width = grid, x.shape[-1]
        return torch.cat(grid._seq_all_gather(x), dim=-1)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        grid, w = ctx.grid, ctx.width
        g = g.contiguous()
        dist.all_reduce(g, group=grid.seq_group)  # every seq rank's loss read the block
        return g[..., grid.s * w: (grid.s + 1) * w].contiguous(), None


def shard_model(model: torch.nn.Module, grid: ProcessGrid, shard_time: bool = True) -> None:
    """Bind ``model``'s BatchNorms to ``grid`` (statistics over every rank)
    and, when the time axis is split, its kernel-3 convolutions (the halo
    exchange)."""
    from ..models.unet import _HaloConv, _TrainStatsBN

    for m in model.modules():
        if isinstance(m, _TrainStatsBN):
            m.shard = grid
        elif isinstance(m, _HaloConv) and shard_time:
            m.shard = grid


def shard_batch(batch: Dict[str, torch.Tensor], specs: Dict[str, tuple],
                grid: ProcessGrid, axes=("data", "seq")) -> Dict[str, torch.Tensor]:
    """This rank's block of a batch along ``axes``, per ``specs`` (axis
    name or None per dimension, ``train/loop.py::batch_partition_specs``)."""
    index = {"data": (grid.d, grid.data), "seq": (grid.s, grid.seq)}
    out = {}
    for k, v in batch.items():
        for dim, axis in enumerate(specs[k]):
            if axis not in axes:
                continue
            i, n = index[axis]
            size = v.shape[dim]
            if size % n:
                raise ValueError(f"{k} dimension {dim} ({size}) does not split over "
                                 f"the {n} entries of the mesh's {axis!r} axis")
            v = v.narrow(dim, i * (size // n), size // n)
        out[k] = v.contiguous()
    return out
