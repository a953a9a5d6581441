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

On the card (``prepare_nhwc``, which ``engine.Detector`` calls when it
places a folded bfloat16 model there), inference runs channels-last (NHWC)
on the transposed image (time as rows): every activation keeps the layout
cuDNN's tensor-core engines take, so no convolution transposes its input or
its output; each ResBlock is three convolutions with the bias, residual add
and ReLU in their epilogues (``CudnnEpilogues``); the first block reads the mel's
3×3 neighbourhoods (``nhwc_im2col``), and the mask head is one GEMM over
each frame's features.  The plan's kernels carry channel scales that make
every bias exact in bfloat16 (``ResBlock.prepare_nhwc``).  The path is
chosen from what the forward can see (a CUDA input, bfloat16 weights,
folded, eval mode, no shard, the plan built); everything else, the CPU and
float32 parity among it, runs the NCHW code unchanged.

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
import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..runtime.metrics import count

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch's convention: Flax's momentum 0.9
DROPOUT_P = 0.1
FILTERS = 32
N_MELS = 128
# the first block's input on the card's path: the one-channel image's 3×3
# neighbourhoods (9 taps), zero-padded to a width that tensor-core engines
# take in bf16 NHWC (16 × 2 bytes)
NHWC_IN_CHANNELS = 16

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
        self.nhwc_ready = False

    def prepare_nhwc(self, in_scale: Optional[torch.Tensor] = None,
                     im2col: bool = False) -> torch.Tensor:
        """The channels-last plan's weights, as non-persistent buffers (the
        state dict is unchanged), for the transposed image (time as rows,
        ``SpecUNet2D._trunk``): the 3×3 kernels transposed, every kernel in
        channels-last, and conv2's bias plus the shortcut's, which one
        epilogue adds.

        Each bias is made exact in bfloat16 (``_bf16_exact_scale``): the
        channels of conv1's output and of the block's output are scaled by
        ``t`` and ``s`` (each within 2⁻⁸ of 1, and through ReLU), and the
        kernels that read them divided by it.  ``in_scale`` is the scale of
        the input's channels, which this block's kernels divide by; the
        block returns ``s``.  A rounded bias would shift every activation of
        its channel alike, an error that overlapping windows do not average
        out, and the sum b2 + b_r rounds coarser than each of them.

        ``im2col``: the block takes ``nhwc_im2col``'s 3×3 neighbourhoods of
        a one-channel image, so conv1 and the shortcut become 1×1 kernels
        over those ``NHWC_IN_CHANNELS`` channels.  Needs a folded 2-D
        block."""
        dtype = self.conv1[0].weight.dtype
        (wr, br), (w1, b1), (w2, b2) = (
            (c[0].weight.detach().double(), c[0].bias.detach().double())
            for c in (self.residual, self.conv1, self.conv2))
        t, b1 = _bf16_exact_scale(b1)
        s, b2r = _bf16_exact_scale(b2 + br)

        def scaled(w, out, inp):
            return w * out.view(-1, 1, 1, 1) / inp.view(1, -1, 1, 1)

        inp = (torch.ones(w1.shape[1], dtype=torch.float64, device=w1.device)
               if in_scale is None else in_scale.to(w1.device, torch.float64))
        w1, wr, w2 = scaled(w1, t, inp), scaled(wr, s, inp), scaled(w2, s, t)
        w1, w2 = w1.transpose(2, 3), w2.transpose(2, 3)
        self.nhwc_pad1 = 1
        if im2col:  # tap k = 3·dt + dh; the shortcut reads the centre tap
            w1 = F.pad(w1.reshape(-1, 9), (0, NHWC_IN_CHANNELS - 9))[..., None, None]
            wr = F.pad(wr.reshape(-1, 1), (4, NHWC_IN_CHANNELS - 5))[..., None, None]
            self.nhwc_pad1 = 0

        def put(name, w):
            fmt = torch.channels_last if w.dim() == 4 else torch.contiguous_format
            self.register_buffer(name, w.to(dtype).contiguous(memory_format=fmt),
                                 persistent=False)

        put("nhwc_wr", wr)
        put("nhwc_w1", w1)
        put("nhwc_w2", w2)
        put("nhwc_b1", b1)
        put("nhwc_b2r", b2r)
        self.nhwc_ready = True
        return s

    def forward_nhwc(self, x: torch.Tensor, ops) -> torch.Tensor:
        """The block on a channels-last input (its channels scaled by
        ``prepare_nhwc``'s ``in_scale``):
        ``relu(conv2(relu(conv1(x) + b1)) + (b2 + b_r) + residual(x))``,
        scaled by ``prepare_nhwc``'s result; the shortcut without its bias,
        the rest in two epilogues."""
        r = ops.conv(x, self.nhwc_wr, 0)
        out = ops.conv_relu(x, self.nhwc_w1, self.nhwc_b1, self.nhwc_pad1)
        return ops.conv_add_relu(out, self.nhwc_w2, r, self.nhwc_b2r, 1)

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


def nhwc_im2col(mel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, T) image → (B, NHWC_IN_CHANNELS, T, H) channels-last: the
    transposed image's 3×3 neighbourhoods, tap (dt, dh) in channel
    3·dt + dh, zero outside the image and in the channels past the ninth."""
    B, H, T = mel.shape
    p = F.pad(mel.to(dtype), (1, 1, 1, 1))                     # (B, H+2, T+2)
    s0, s1, s2 = p.stride()
    taps = p.as_strided((B, T, H, 3, 3), (s0, s2, s1, s2, s1), p.storage_offset())
    x = p.new_zeros((B, T, H, NHWC_IN_CHANNELS))
    x[..., :9].unflatten(-1, (3, 3)).copy_(taps)
    return x.permute(0, 3, 1, 2)


def nhwc_pool(x: torch.Tensor) -> torch.Tensor:
    """``F.max_pool2d(x, 2)`` of a channels-last ``x`` as one reduction in
    place of the pooling kernel, which also writes int64 indices."""
    B, C, H, W = x.shape
    return (x.permute(0, 2, 3, 1).unflatten(2, (W // 2, 2)).unflatten(1, (H // 2, 2))
            .amax((2, 4)).permute(0, 3, 1, 2))


def nhwc_up_cat(skip: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """``torch.cat([skip, _up(low)], 1)`` in channels-last, written once: the
    skip and the ×2 nearest-neighbour broadcast of ``low`` copied into
    their channels of one buffer, with no upsampled tensor between."""
    B, C1, H, W = skip.shape
    C2 = low.shape[1]
    out = skip.new_empty((B, H, W, C1 + C2))
    # the copies move 8-byte words (4 bf16 channels): channel counts are
    # multiples of 4, and a copy of 2-byte elements runs at half the speed
    g = 8 // out.element_size()
    words = out.view(torch.int64)
    words[..., :C1 // g] = skip.permute(0, 2, 3, 1).view(torch.int64)
    words[..., C1 // g:].unflatten(2, (W // 2, 2)).unflatten(1, (H // 2, 2)).copy_(
        low.permute(0, 2, 3, 1).view(torch.int64)[:, :, None, :, None])
    return out.permute(0, 3, 1, 2)


def _bf16_exact_scale(b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, bias): ``bias`` = ``b`` rounded to bfloat16 and ``scale`` =
    bias / b (1 where b is 0), float64: scaling a channel's kernel by
    ``scale`` makes the rounded bias its exact one."""
    m = b.to(torch.bfloat16).double()
    return torch.where(b == 0, torch.ones_like(b), m / torch.where(b == 0, 1.0, b)), m


class CudnnEpilogues:
    """The card's three convolution forms (stride 1, square ``pad``): a
    bias-free convolution, and cuDNN's fused convolution + bias + ReLU and
    convolution + bias + add + ReLU, which write the activation once in
    the input's channels-last layout."""

    @staticmethod
    def conv(x, w, pad):
        return F.conv2d(x, w, None, 1, pad)

    @staticmethod
    def conv_relu(x, w, b, pad):
        return torch.cudnn_convolution_relu(x, w, b, (1, 1), (pad, pad), (1, 1), 1)

    @staticmethod
    def conv_add_relu(x, w, z, b, pad):
        return torch.cudnn_convolution_add_relu(x, w, z, 1.0, b, (1, 1), (pad, pad),
                                                (1, 1), 1)


class PlainEpilogues:
    """The same three forms in plain ops, on any device and type: the CPU
    tests hold the fused plan to the NCHW blocks with these."""

    @staticmethod
    def conv(x, w, pad):
        return F.conv2d(x, w, None, 1, pad)

    @staticmethod
    def conv_relu(x, w, b, pad):
        return F.relu(F.conv2d(x, w, b, 1, pad))

    @staticmethod
    def conv_add_relu(x, w, z, b, pad):
        return F.relu(F.conv2d(x, w, b, 1, pad) + z)



# the channels-last plan's 2-D blocks in the order the trunk runs them, each
# with the blocks whose outputs make its input's channels (a decoder
# block's: the skip, then the upsampled one)
_NHWC_INPUTS = (
    ("conv1_1", ()), ("conv2_1", ("conv1_1",)), ("conv3_1", ("conv2_1",)),
    ("conv4_1", ("conv3_1",)), ("conv_bottleneck", ("conv4_1",)),
    ("encoder_out", ("conv_bottleneck",)), ("conv6", ("conv4_1", "encoder_out")),
    ("conv7", ("conv3_1", "conv6")), ("conv8", ("conv2_1", "conv7")),
    ("conv9_1", ("conv1_1", "conv8")), ("spec_output_conv.0", ("conv9_1",)))


def _rebuild_nhwc(model: "SpecUNet2D", _keys) -> None:
    if model.conv1_1.nhwc_ready:
        model.prepare_nhwc()


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

    def prepare_nhwc(self) -> "SpecUNet2D":
        """Build the channels-last plan of every 2-D block and of both heads
        (non-persistent buffers; a later ``load_state_dict`` rebuilds them):
        each block divides its kernels by the channel scales of the blocks
        that feed it, and the heads by conv9's (``ResBlock.prepare_nhwc``).
        Call it on the float32 weights, before the cast to bfloat16, so
        that each derived kernel is rounded once."""
        if not self.folded:
            raise ValueError("prepare_nhwc needs a folded model")
        scale = {}
        for name, inputs in _NHWC_INPUTS:
            in_scale = torch.cat([scale[i] for i in inputs]) if inputs else None
            scale[name] = self.get_submodule(name).prepare_nhwc(in_scale, name == "conv1_1")
        dtype = self.conv_flatten.weight.dtype
        spec_w = self.spec_output_conv[1].weight.detach().double()
        spec_w = spec_w / scale["spec_output_conv.0"].view(1, -1, 1, 1)
        self.register_buffer("nhwc_spec_w", spec_w.to(dtype).contiguous(
            memory_format=torch.channels_last), persistent=False)
        # conv_flatten over conv9 as it lies (time, mel, channel): one GEMM
        # whose reduction index is mel·32 + channel
        w = self.conv_flatten.weight.detach().double()[..., 0]        # (4, 32, 128)
        w = w / scale["conv9_1"].view(1, -1, 1)
        self.register_buffer("nhwc_flat_w", w.transpose(1, 2).reshape(w.shape[0], -1)
                             .to(dtype).contiguous(), persistent=False)
        if not hasattr(self, "_nhwc_hook"):
            self._nhwc_hook = self.register_load_state_dict_post_hook(_rebuild_nhwc)
        return self

    def _trunk(self, mel: torch.Tensor, gen: Optional[torch.Generator] = None,
               ops=None) -> torch.Tensor:
        """(B, 128, 256) → conv9 features (B, 32, 128, 256).  With ``ops``
        (``CudnnEpilogues`` or ``PlainEpilogues``) the channels-last plan, on the
        transposed image (time as rows, features (B, 32, 256, 128) with
        conv9_1's channel scales, which the heads' plan undoes): each
        frame's conv9 features then lie together for the mask head."""
        if ops is None:
            x = mel.to(self.conv1_1.conv1[0].weight.dtype).unsqueeze(1)
            pool = functools.partial(F.max_pool2d, kernel_size=2)

            def up_cat(skip, low):
                return torch.cat([skip, _up(low)], 1)

            def block(m, x):
                return m(x, gen)
        else:
            x = nhwc_im2col(mel, self.conv1_1.nhwc_w1.dtype)
            pool, up_cat = nhwc_pool, nhwc_up_cat

            def block(m, x):
                return m.forward_nhwc(x, ops)
        conv1 = block(self.conv1_1, x)
        conv2 = block(self.conv2_1, pool(conv1))
        conv3 = block(self.conv3_1, pool(conv2))
        conv4 = block(self.conv4_1, pool(conv3))
        enc = block(self.encoder_out, block(self.conv_bottleneck, pool(conv4)))
        # decoder: concat order [skip, up] as torch.cat([skip, up], dim=1)
        conv6 = block(self.conv6, up_cat(conv4, enc))
        conv7 = block(self.conv7, up_cat(conv3, conv6))
        conv8 = block(self.conv8, up_cat(conv2, conv7))
        return block(self.conv9_1, up_cat(conv1, conv8))

    def _mask_head(self, conv9: torch.Tensor, gen: Optional[torch.Generator] = None,
                   nhwc: bool = False) -> torch.Tensor:
        if nhwc:
            # conv9 (B, 32, T, H) in channels-last: one GEMM over each frame's
            # (mel, channel) features, as conv_flatten
            B, C, T, H = conv9.shape
            feats = conv9.permute(0, 2, 3, 1).reshape(B * T, H * C)
            flat = F.relu(F.linear(feats, self.nhwc_flat_w, self.conv_flatten.bias))
            flat = flat.view(B, T, -1).transpose(1, 2).contiguous()    # (B, 4, 256)
        else:
            w = self.conv_flatten.weight[..., 0]                     # (4, 32, 128)
            flat = torch.einsum("bcht,och->bot", conv9, w)
            flat = F.relu(flat + self.conv_flatten.bias[None, :, None])
        block, conv = self.mask_output_conv
        m = conv(block(flat, gen))                                # (B, 1, 256)
        return m[:, 0].to(torch.float32)

    def _ops(self, mel: torch.Tensor):
        """``CudnnEpilogues`` where the channels-last path applies (a CUDA
        input, a prepared folded model in bfloat16, eval mode, no shard;
        counted as ``batches_nhwc`` in the thread's recorder), else None."""
        conv = self.conv1_1.conv1[0]
        if not (mel.is_cuda and self.conv1_1.nhwc_ready and not self.training
                and conv.weight.dtype == torch.bfloat16 and conv.shard is None):
            return None
        count("batches_nhwc")
        return CudnnEpilogues

    def mask_logits(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, 128, 256) → raw per-frame speech logits (B, 256) float32."""
        ops = self._ops(mel)
        return self._mask_head(self._trunk(mel, ops=ops), nhwc=ops is not None)

    def forward(self, mel: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 128, 256) → (spec (B, 2, 128, 256), mask logits (B, 256)),
        both float32.  ``generator`` draws the dropout masks in training
        mode."""
        ops = self._ops(mel)
        conv9 = self._trunk(mel, generator, ops)
        block, conv = self.spec_output_conv
        if ops is None:
            spec = F.relu(conv(block(conv9, generator))).to(torch.float32)
        else:  # back to (B, 2, 128, 256), contiguous
            spec = F.conv2d(block.forward_nhwc(conv9, ops), self.nhwc_spec_w, conv.bias)
            spec = F.relu(spec).transpose(2, 3)
            spec = spec.to(torch.float32, memory_format=torch.contiguous_format)
        return spec, self._mask_head(conv9, generator, ops is not None)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
