"""SpecUNet_2D — the speech detector as a PyTorch module (NCHW).

Architecture of ``root/code/backend/pytorch_neural_nets.py:79-197``, a
~1.71 M-parameter 2-D U-Net over (128 mel × 256 frame) log-mel windows with
two heads:

  * spec head — speech/environment separation masks, (B, 2, 128, 256),
    ReLU'd (:126-130, 183-185)
  * mask head — per-frame speech logits, (B, 256), no sigmoid (:133-140,
    187-195)

Parameter names follow the reference's ``state_dict`` (``conv1_1.conv1.0.
weight``, ``spec_output_conv.1.bias`` …), so a reference ``.pth`` loads
as it is.  With ``folded=True`` the BatchNorms are gone and every conv has a
bias (``models/fold.py``).  The mel frontend lives in ``ops``; the module
takes the log-mel image.

``mask_logits`` runs the mask head only: detection never needs the spec
head, whose ResBlock at 128×256 would be about a fifth of the forward.

Training mode (``model.train()``) follows the JAX package's Flax module
(``softspoken_tpu/models/unet.py:176-266``), not ``torch.nn``'s defaults:

  * BatchNorm normalizes with the batch statistics and updates its running
    statistics as Flax does, ``ra = 0.9·ra + 0.1·batch_stat`` with the
    **biased** batch variance (``torch.nn.BatchNorm`` would update with the
    unbiased one, ×n/(n−1), and every trained checkpoint's running variances
    would drift from the JAX trainer's).  The statistics and the
    normalization run in float32 at least, whatever the input type.
  * Dropout2d (p = 0.1) after the add+ReLU of every 2-D block drops whole
    channel maps; the 1-D mask block drops whole channels over time.  The
    masks come from the ``generator`` passed to ``forward``.

A bfloat16 training step runs the module under ``torch.autocast`` with
float32 parameters (``train/loop.py``).  Eval mode computes what it always
did.

Sharded training (``parallel/grid.py::shard_model``) sets ``shard`` on the
BatchNorms and the kernel-3 convolutions: the BatchNorm statistics then
cover every rank's shard, and each kernel-3 convolution first takes one frame
from each neighbour along time (the last axis), which is split over the
ranks of the ``seq`` axis.  Dropout masks then come from ``RowDraws``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch's convention: Flax's momentum 0.9
DROPOUT_P = 0.1
FILTERS = 32
N_MELS = 128

# (in, out) channels of every residual block — pytorch_neural_nets.py
RES_BLOCK_SHAPES = {
    "conv1_1": (1, 32), "conv2_1": (32, 64), "conv3_1": (64, 96),
    "conv4_1": (96, 128), "conv_bottleneck": (128, 128),
    "encoder_out": (128, 128), "conv6": (256, 96), "conv7": (192, 64),
    "conv8": (128, 32), "conv9_1": (64, 32),
    "spec_output_conv.0": (32, 32), "mask_output_conv.0": (4, 4),
}


class _TrainStatsBN:
    """BatchNorm whose training mode is Flax's (see the module docstring);
    eval mode is torch's, unchanged.  With ``shard`` set (a
    ``parallel.grid.ProcessGrid``) the batch statistics cover every rank's
    rows and frames."""

    shard = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = [0] + list(range(2, x.dim()))
        if self.shard is not None:
            return self._sharded_forward(x, dims)
        with torch.no_grad():
            stat_t = torch.promote_types(x.dtype, torch.float32)
            var, mean = torch.var_mean(x.to(stat_t), dim=dims, correction=0)
            self.running_mean.mul_(1.0 - BN_MOMENTUM).add_(mean, alpha=BN_MOMENTUM)
            self.running_var.mul_(1.0 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)
            self.num_batches_tracked.add_(1)
        # batch statistics, biased variance, float32 arithmetic
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _sharded_forward(self, x: torch.Tensor, dims) -> torch.Tensor:
        """The same normalization with statistics over every rank's shard
        (equal shards): each rank's own mean and biased variance
        (``torch.var_mean``), gathered from every rank with a
        differentiable all-gather and merged exactly (Chan et al.: the
        variance is the mean of the shards' variances plus the variance of
        their means; no ``E[x²] − mean²`` cancellation), so that the
        gradient flows through the global mean and variance as through
        the unsharded step's."""
        stat_t = torch.promote_types(x.dtype, torch.float32)
        xs = x.to(stat_t)
        var_k, mean_k = torch.var_mean(xs, dim=dims, correction=0)
        stats = self.shard.all_gather(torch.stack([mean_k, var_k]))  # (world, 2, C)
        mean = stats[:, 0].mean(0)
        var = stats[:, 1].mean(0) + ((stats[:, 0] - mean) ** 2).mean(0)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - BN_MOMENTUM).add_(mean.detach(), alpha=BN_MOMENTUM)
            self.running_var.mul_(1.0 - BN_MOMENTUM).add_(var.detach(), alpha=BN_MOMENTUM)
            self.num_batches_tracked.add_(1)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        y = (xs - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


class BatchNorm2d(_TrainStatsBN, nn.BatchNorm2d):
    pass


class BatchNorm1d(_TrainStatsBN, nn.BatchNorm1d):
    pass


@dataclasses.dataclass
class RowDraws:
    """The dropout generator of a shard that holds rows [start, start + B)
    of a batch of ``total`` rows: every mask is drawn for the whole batch
    and sliced, so the shard drops what the unsharded step drops."""

    generator: torch.Generator
    total: int
    start: int


def channel_dropout(x: torch.Tensor, p: float,
                    generator: Union[torch.Generator, RowDraws, None] = None) -> torch.Tensor:
    """Drop whole channels of (B, C, ...) with probability ``p`` and scale the
    kept ones by 1/(1−p): Flax ``nn.Dropout(p, broadcast_dims=…)`` over every
    axis but batch and channel (Dropout2d / Dropout1d)."""
    keep_prob = 1.0 - p
    shape = x.shape[:2] + (1,) * (x.dim() - 2)
    if isinstance(generator, RowDraws):
        full = (generator.total,) + shape[1:]
        keep = (torch.rand(full, generator=generator.generator, device=x.device)
                [generator.start: generator.start + x.shape[0]] < keep_prob)
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))
    keep = torch.rand(shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class _PointwiseConv:
    """A 1×1 convolution that in inference on the CPU always runs through
    oneDNN (float32 and bfloat16; float64 has no oneDNN kernel).  Training
    keeps ``F.conv2d`` and its autograd and autocast rules as they were.

    ``F.conv2d`` picks oneDNN for a 1×1 convolution of a batch under 16
    only when more than one intra-op thread is available, and another
    kernel with another rounding on one thread; every other convolution of
    the model is oneDNN's at any thread count.  The weights and the state
    dict keys are those of ``nn.Conv2d`` / ``nn.Conv1d``.
    """

    def _conv_forward(self, x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor]) -> torch.Tensor:
        if (x.device.type == "cpu" and x.dtype in (torch.float32, torch.bfloat16)
                and not torch.is_grad_enabled() and not torch.is_autocast_enabled("cpu")
                and torch.backends.mkldnn.is_available()):
            return torch.ops.aten.mkldnn_convolution(
                x.contiguous(), weight, bias, list(self.padding), list(self.stride),
                list(self.dilation), self.groups)
        return super()._conv_forward(x, weight, bias)


class PointwiseConv2d(_PointwiseConv, nn.Conv2d):
    pass


class PointwiseConv1d(_PointwiseConv, nn.Conv1d):
    pass


class _HaloConv:
    """A kernel-3 convolution whose time axis (the last) may be split over
    the ranks of the ``seq`` axis: with ``shard`` set, it takes one frame
    from each neighbouring shard (zeros at the ends of the sequence, the
    zero padding's values) and pads only the other axes itself.  The
    weights and the state dict keys are those of ``nn.Conv2d`` /
    ``nn.Conv1d``."""

    shard = None

    def _conv_forward(self, x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor]) -> torch.Tensor:
        if self.shard is None:
            return super()._conv_forward(x, weight, bias)
        padding = tuple(self.padding[:-1]) + (0,)
        return self._conv(self.shard.halo(x), weight, bias, self.stride, padding,
                          self.dilation, self.groups)


class HaloConv2d(_HaloConv, nn.Conv2d):
    _conv = staticmethod(F.conv2d)


class HaloConv1d(_HaloConv, nn.Conv1d):
    _conv = staticmethod(F.conv1d)


class ResBlock(nn.Module):
    """Residual conv block (pytorch_neural_nets.py:7-77), 2-D or 1-D.

    1×1 conv+BN shortcut; 3×3 conv-BN-ReLU, 3×3 conv-BN; add, ReLU, then
    channel dropout in training mode.
    """

    def __init__(self, cin: int, cout: int, folded: bool = False, oned: bool = False,
                 dropout_p: float = DROPOUT_P):
        super().__init__()
        conv = HaloConv1d if oned else HaloConv2d
        bn = BatchNorm1d if oned else BatchNorm2d
        self.dropout_p = dropout_p

        def seq(ci, k, pad):
            cls = (PointwiseConv1d if oned else PointwiseConv2d) if k == 1 else conv
            layers = [cls(ci, cout, k, padding=pad, bias=folded)]
            if not folded:
                layers.append(bn(cout, eps=BN_EPS))
            return nn.Sequential(*layers)

        self.residual = seq(cin, 1, 0)
        self.conv1 = seq(cin, 3, 1)
        self.conv2 = seq(cout, 3, 1)

    def forward(self, x: torch.Tensor,
                generator: Union[torch.Generator, RowDraws, None] = None) -> torch.Tensor:
        identity = self.residual(x)
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out) + identity)
        if self.training and self.dropout_p > 0:
            out = channel_dropout(out, self.dropout_p, generator)
        return out


def _up(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour ×2 upsample (nn.Upsample(mode='nearest'))."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class SpecUNet2D(nn.Module):
    """Input (B, 128, 256) log-mel; see ``forward`` and ``mask_logits``."""

    def __init__(self, folded: bool = False, dropout_p: float = DROPOUT_P):
        super().__init__()
        self.folded = folded
        for name, (ci, co) in RES_BLOCK_SHAPES.items():
            if "." not in name:
                setattr(self, name, ResBlock(ci, co, folded, dropout_p=dropout_p))
        self.spec_output_conv = nn.Sequential(
            ResBlock(FILTERS, FILTERS, folded, dropout_p=dropout_p),
            PointwiseConv2d(FILTERS, 2, 1))
        # Conv2d(32→4, kernel=(128, 1)): a VALID conv with one vertical
        # position, computed in _flatten as one contraction over (mel, channel)
        self.conv_flatten = nn.Conv2d(FILTERS, 4, (N_MELS, 1))
        self.mask_output_conv = nn.Sequential(
            ResBlock(4, 4, folded, oned=True, dropout_p=dropout_p),
            PointwiseConv1d(4, 1, 1))

    def _trunk(self, mel: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, 128, 256) → conv9 features (B, 32, 128, 256)."""
        dtype = self.conv1_1.conv1[0].weight.dtype
        x = mel.to(dtype).unsqueeze(1)
        conv1 = self.conv1_1(x, gen)
        conv2 = self.conv2_1(F.max_pool2d(conv1, 2), gen)
        conv3 = self.conv3_1(F.max_pool2d(conv2, 2), gen)
        conv4 = self.conv4_1(F.max_pool2d(conv3, 2), gen)
        enc = self.encoder_out(self.conv_bottleneck(F.max_pool2d(conv4, 2), gen), gen)
        # decoder: concat order [skip, up] as torch.cat([skip, up], dim=1)
        conv6 = self.conv6(torch.cat([conv4, _up(enc)], 1), gen)
        conv7 = self.conv7(torch.cat([conv3, _up(conv6)], 1), gen)
        conv8 = self.conv8(torch.cat([conv2, _up(conv7)], 1), gen)
        return self.conv9_1(torch.cat([conv1, _up(conv8)], 1), gen)

    def _mask_head(self, conv9: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        w = self.conv_flatten.weight[..., 0]                     # (4, 32, 128)
        flat = torch.einsum("bcht,och->bot", conv9, w)
        flat = F.relu(flat + self.conv_flatten.bias[None, :, None])
        block, conv = self.mask_output_conv
        m = conv(block(flat, gen))                                # (B, 1, 256)
        return m[:, 0].to(torch.float32)

    def mask_logits(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, 128, 256) → raw per-frame speech logits (B, 256) float32."""
        return self._mask_head(self._trunk(mel))

    def forward(self, mel: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 128, 256) → (spec (B, 2, 128, 256), mask logits (B, 256)),
        both float32.  ``generator`` draws the dropout masks in training
        mode."""
        conv9 = self._trunk(mel, generator)
        block, conv = self.spec_output_conv
        spec = F.relu(conv(block(conv9, generator))).to(torch.float32)
        return spec, self._mask_head(conv9, generator)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
