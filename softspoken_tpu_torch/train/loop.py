"""Training: the loss, the optimizer and the train step (the JAX package's
``train/loop.py``).

The reference ships no training loop; the loss is the JAX package's choice,
matching the two heads' semantics (pytorch_neural_nets.py:126-140):

  * mask head emits raw per-frame logits → sigmoid BCE against the 0/1
    frame mask (``train.targets.frame_mask``)
  * spec head emits ReLU'd separation masks → MSE against the
    speech/environment magnitude targets

The optimizer is AdamW over every parameter, BatchNorm scale and shift
included: ``optax.adamw(lr, weight_decay=1e-4)`` with no mask.

Precision.  The step sets no precision flag: it runs at torch's defaults
(cuDNN convolutions may use TF32, matmuls stay float32), as the JAX step
runs at its backend's default precision rather than HIGHEST; a caller that
needs float32 wraps it in ``ops.mel.fp32_matmul()``.  With
``compute_dtype=torch.bfloat16`` the forward runs under ``torch.autocast``:
parameters, gradients and optimizer state stay float32, BatchNorm's
statistics and normalization run in float32, and the loss is float32.

Mesh training (``make_sharded_train_step``) runs one process per mesh entry
on ``torch.distributed`` (``parallel/grid.py``): the batch rows split over
``data``, the time axis over ``seq``, and the step's loss, gradients,
parameters, BatchNorm statistics and AdamW state are the unsharded step's
on the global batch.  The dropout masks are drawn for the global batch on
every rank and sliced (``models.unet.RowDraws``).
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models import load_unfolded
from ..models.unet import DROPOUT_P, RowDraws, SpecUNet2D

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer, the
    step counter, and the seed the dropout masks derive from."""

    model: SpecUNet2D
    optimizer: torch.optim.Optimizer
    step: int = 0
    seed: int = 0
    compute_dtype: torch.dtype = torch.float32

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def make_optimizer(model: torch.nn.Module, learning_rate: float = 1e-3,
                   weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate, weight_decay=weight_decay)``: b1 0.9,
    b2 0.999, eps 1e-8, decoupled decay on every parameter."""
    return torch.optim.AdamW(model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def create_train_state(
    seed: int = 0,
    learning_rate: float = 1e-3,
    weight_decay: float = 1e-4,
    resume: Optional[str] = None,
    compute_dtype: torch.dtype = torch.float32,
    device="cpu",
    dropout_p: float = DROPOUT_P,
) -> TrainState:
    """A fresh model and optimizer on ``device``.

    The initial weights are torch's default initialization (the reference
    model's) from ``seed``.  ``resume`` warm-starts the weights and the step
    counter from a ``.pth`` (its ``epoch``; the ``-1`` of a converted file
    counts as 0).  Optimizer moments restart fresh, as in the JAX trainer.
    """
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = SpecUNet2D(folded=False, dropout_p=dropout_p)
    step0 = 0
    if resume:
        from ..ckpt import load_pth

        sd, epoch = load_pth(resume)
        load_unfolded(model, sd)
        step0 = max(0, int(epoch))
    model.to(device)
    return TrainState(model, make_optimizer(model, learning_rate, weight_decay),
                      step=step0, seed=seed, compute_dtype=compute_dtype)


def boundary_weights(mask: torch.Tensor, boundary_weight: float,
                     halo: int = 4) -> torch.Tensor:
    """Per-frame loss weights emphasizing speech onsets/offsets.

    ``mask`` (B, T) in {0,1} → weights (B, T): 1 everywhere, plus
    ``boundary_weight`` within ``halo`` frames of any 0↔1 transition,
    mean-normalized so the loss scale is unchanged.
    """
    trans = (torch.diff(mask, dim=-1).abs() > 0.5).float()          # (B, T-1)
    near = F.pad(trans, (0, 1))
    # dilate the transition indicator by ±halo with a max-pool
    near = F.max_pool1d(near.unsqueeze(1), 2 * halo + 1, stride=1, padding=halo)[:, 0]
    w = 1.0 + boundary_weight * near
    return w / w.mean(dim=-1, keepdim=True)


def loss_fn(model: SpecUNet2D, batch: Dict[str, torch.Tensor],
            boundary_weight: float = 0.0,
            generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: mel (B, 128, 256), mask (B, 256) in {0,1}, spec (B, 2, 128, 256)
    targets.  Returns (loss, {"loss", "mask_loss", "spec_loss"})."""
    spec_out, mask_logits = model(batch["mel"], generator)
    bce = F.binary_cross_entropy_with_logits(mask_logits, batch["mask"], reduction="none")
    if boundary_weight > 0.0:
        bce = bce * boundary_weights(batch["mask"], boundary_weight)
    mask_loss = bce.mean()
    spec_loss = torch.mean((spec_out - batch["spec"]) ** 2)
    loss = mask_loss + spec_loss
    return loss, {"loss": loss, "mask_loss": mask_loss, "spec_loss": spec_loss}


def dropout_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The dropout masks' generator for ``step``: seeded from (seed, step),
    the counterpart of the JAX step's ``fold_in(rng, state.step)``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]))
    return g


def autocast(device: torch.device, dtype: torch.dtype):
    """The forward's compute-type context: autocast for bfloat16."""
    if dtype == torch.float32:
        return nullcontext()
    return torch.autocast(device.type, dtype=dtype)


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               boundary_weight: float = 0.0) -> Dict[str, torch.Tensor]:
    """One optimizer step in training mode; returns the step's metrics as
    detached device scalars."""
    model, dev = state.model, state.device
    model.train()
    gen = dropout_generator(state.seed, state.step, dev)
    with autocast(dev, state.compute_dtype):
        loss, metrics = loss_fn(model, batch, boundary_weight, gen)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


# ---------------------------------------------------------------------------
# mesh training

def batch_partition_specs(mesh, shard_time: bool = True) -> Dict[str, tuple]:
    """The mesh axis each training-batch dimension splits over (None:
    whole), in the port's layout: rows over ``data``, the time axis (last)
    over ``seq`` when ``shard_time`` and the mesh has that axis; the mask
    keeps whole rows.  The one source of the batch layout for both sharded
    trainers (``make_sharded_train_step``, and
    ``device_data.make_sharded_fused_train_step``)."""
    seq = "seq" if (shard_time and "seq" in mesh.axis_names) else None
    return {"mel": ("data", None, seq), "mask": ("data", None),
            "spec": ("data", None, None, seq)}


def _sharded_loss(model: SpecUNet2D, batch: Dict[str, torch.Tensor], grid,
                  shard_time: bool, boundary_weight: float, generator
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """This rank's share of the global loss: the losses' sums over its
    block divided by the global count and by the number of ranks that
    hold the same block, so that the shares sum to ``loss_fn`` on the
    global batch."""
    spec_out, mask_logits = model(batch["mel"], generator)
    if shard_time:
        mask_logits = grid.gather_seq(mask_logits)  # whole rows, as the mask
    bce = F.binary_cross_entropy_with_logits(mask_logits, batch["mask"], reduction="none")
    if boundary_weight > 0.0:
        bce = bce * boundary_weights(batch["mask"], boundary_weight)
    mask_loss = bce.sum() / (bce.numel() * grid.world_size)
    spec_loss = torch.sum((spec_out - batch["spec"]) ** 2) / (spec_out.numel() * grid.world_size)
    loss = mask_loss + spec_loss
    return loss, {"loss": loss, "mask_loss": mask_loss, "spec_loss": spec_loss}


def sharded_step(state: TrainState, batch: Dict[str, torch.Tensor], grid,
                 shard_time: bool, boundary_weight: float = 0.0) -> Dict[str, torch.Tensor]:
    """One optimizer step on this rank's block of the global batch (the
    model bound by ``parallel.grid.shard_model``); returns this rank's
    shares of the metrics."""
    model, dev = state.model, state.device
    model.train()
    rows = batch["mel"].shape[0]
    gen = RowDraws(dropout_generator(state.seed, state.step, dev), rows * grid.data, grid.d * rows)
    with autocast(dev, state.compute_dtype):
        loss, metrics = _sharded_loss(model, batch, grid, shard_time, boundary_weight, gen)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    grid.all_reduce_grads(model.parameters())
    state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


def global_metrics(shares: Dict[str, torch.Tensor], grid) -> Dict[str, torch.Tensor]:
    """The ranks' metric shares summed over every rank, in one all-reduce."""
    names = sorted(shares)
    total = grid.sum_(torch.stack([shares[k] for k in names]))
    return dict(zip(names, total.unbind()))


def make_sharded_train_step(state: TrainState, mesh, shard_time: bool = True,
                            boundary_weight: float = 0.0):
    """The train step over ``mesh`` (axes ``data`` and, optionally, ``seq``)
    in a process group of one process per mesh entry; every rank calls
    this once.  Returns ``(step, shard)``: ``shard(batch)`` is this rank's
    block of a global batch (``batch_partition_specs``; ``axes=("seq",)``
    cuts only the time axis of a batch of this rank's rows), and
    ``step(state, block)`` takes one optimizer step and returns the global
    metrics."""
    from ..parallel.grid import ProcessGrid, shard_batch, shard_model

    grid = ProcessGrid(mesh)
    if grid.device != state.device:
        raise ValueError(f"rank {grid.rank}'s mesh device is {grid.device}, "
                         f"the train state lives on {state.device}")
    shard_time = shard_time and mesh.shape.get("seq", 1) > 1  # a 1-wide axis splits nothing
    shard_model(state.model, grid, shard_time)
    specs = batch_partition_specs(mesh, shard_time)

    def step(state: TrainState, block: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return global_metrics(sharded_step(state, block, grid, shard_time, boundary_weight),
                              grid)

    def shard(batch: Dict[str, torch.Tensor], axes=("data", "seq")) -> Dict[str, torch.Tensor]:
        return shard_batch(batch, specs, grid, axes)

    return step, shard
