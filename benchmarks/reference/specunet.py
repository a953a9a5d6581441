"""SpecUNet_2D's mask head in eval mode, from the reference's state dict.

The network of ``root/code/backend/pytorch_neural_nets.py`` (AVianEco/
Softspoken): residual blocks of a 1x1 conv + BatchNorm shortcut and two 3x3
conv + BatchNorm layers (add, ReLU); four max-pooled encoder stages (32, 64,
96, 128 channels), two 128-channel bottleneck blocks, a decoder of nearest
x2 upsampling with [skip, up] concatenation, then the mask head: a
(128 x 1) conv to 4 channels over the mel axis, ReLU, a 1-D residual
block and a 1x1 conv to one logit per frame.  Written as functions over
the ``.pth`` state dict, float32; ``q`` rounds every convolution's input
and weight (the control's lower precision).  ``mask_logits`` is the
detection path (eval mode, the mask head).  ``forward_train`` is training
mode with both heads: BatchNorm over the batch's statistics (biased
variance) and channel dropout (p = 0.1) after each block's add and ReLU,
its masks drawn from ``generator`` block by block in the network's order
(encoder, bottleneck, decoder, the spec head's block, the mask head's).
``param_shapes`` lists the state dict the network reads.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

EPS = 1e-5
DROPOUT = 0.1
BLOCKS = {"conv1_1": (1, 32), "conv2_1": (32, 64), "conv3_1": (64, 96),
          "conv4_1": (96, 128), "conv_bottleneck": (128, 128), "encoder_out": (128, 128),
          "conv6": (256, 96), "conv7": (192, 64), "conv8": (128, 32), "conv9_1": (64, 32),
          "spec_output_conv.0": (32, 32), "mask_output_conv.0": (4, 4)}

Q = Optional[Callable[[torch.Tensor], torch.Tensor]]


def load_state(path: str, device) -> Dict[str, torch.Tensor]:
    ck = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.to(device=device, dtype=torch.float32) for k, v in ck["model_state_dict"].items()
            if v.is_floating_point()}


def _conv(x, w, b, q: Q, pad):
    if q is not None:
        x, w = q(x), q(w)
    if x.dim() == 4:
        return F.conv2d(x, w, b, padding=pad)
    return F.conv1d(x, w, b, padding=pad)


def _bn(x, sd, p):
    shape = (1, -1) + (1,) * (x.dim() - 2)
    scale = sd[p + ".weight"] / torch.sqrt(sd[p + ".running_var"] + EPS)
    return (x - sd[p + ".running_mean"].view(shape)) * scale.view(shape) + sd[p + ".bias"].view(shape)


def _bn_train(x, sd, p):
    dims = [0] + list(range(2, x.dim()))
    var, mean = torch.var_mean(x, dim=dims, correction=0)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + EPS)
    return y * sd[p + ".weight"].view(shape) + sd[p + ".bias"].view(shape)


def res_block(x, sd, p: str, q: Q, train: Optional[torch.Generator] = None):
    """Eval mode, or training mode with dropout masks from ``train``."""
    bn = _bn if train is None else _bn_train
    ident = bn(_conv(x, sd[p + ".residual.0.weight"], None, q, 0), sd, p + ".residual.1")
    out = F.relu(bn(_conv(x, sd[p + ".conv1.0.weight"], None, q, 1), sd, p + ".conv1.1"))
    out = F.relu(bn(_conv(out, sd[p + ".conv2.0.weight"], None, q, 1), sd, p + ".conv2.1")
                 + ident)
    if train is None:
        return out
    shape = out.shape[:2] + (1,) * (out.dim() - 2)
    keep = torch.rand(shape, generator=train, device=out.device) < 1.0 - DROPOUT
    return torch.where(keep, out / (1.0 - DROPOUT), torch.zeros((), device=out.device))


def _trunk(mel, sd, q: Q, train=None):
    def up(t):
        return F.interpolate(t, scale_factor=2, mode="nearest")

    x = mel.float().unsqueeze(1)
    c1 = res_block(x, sd, "conv1_1", q, train)
    c2 = res_block(F.max_pool2d(c1, 2), sd, "conv2_1", q, train)
    c3 = res_block(F.max_pool2d(c2, 2), sd, "conv3_1", q, train)
    c4 = res_block(F.max_pool2d(c3, 2), sd, "conv4_1", q, train)
    enc = res_block(res_block(F.max_pool2d(c4, 2), sd, "conv_bottleneck", q, train),
                    sd, "encoder_out", q, train)
    c6 = res_block(torch.cat([c4, up(enc)], 1), sd, "conv6", q, train)
    c7 = res_block(torch.cat([c3, up(c6)], 1), sd, "conv7", q, train)
    c8 = res_block(torch.cat([c2, up(c7)], 1), sd, "conv8", q, train)
    return res_block(torch.cat([c1, up(c8)], 1), sd, "conv9_1", q, train)


def _mask_head(c9, sd, q: Q, train=None):
    flat = F.relu(_conv(c9, sd["conv_flatten.weight"], sd["conv_flatten.bias"], q, 0)[:, :, 0])
    m = res_block(flat, sd, "mask_output_conv.0", q, train)
    return _conv(m, sd["mask_output_conv.1.weight"], sd["mask_output_conv.1.bias"], q, 0)[:, 0]


def mask_logits(mel: torch.Tensor, sd: Dict[str, torch.Tensor], q: Q = None) -> torch.Tensor:
    """(B, 128, 256) log-mel -> (B, 256) per-frame speech logits."""
    return _mask_head(_trunk(mel, sd, q), sd, q)


def forward_train(mel: torch.Tensor, sd: Dict[str, torch.Tensor],
                  generator: torch.Generator, q: Q = None):
    """Training mode: (spec (B, 2, 128, 256), mask logits (B, 256))."""
    c9 = _trunk(mel, sd, q, generator)
    s = res_block(c9, sd, "spec_output_conv.0", q, generator)
    spec = F.relu(_conv(s, sd["spec_output_conv.1.weight"], sd["spec_output_conv.1.bias"], q, 0))
    return spec, _mask_head(c9, sd, q, generator)


def param_shapes() -> Dict[str, tuple]:
    """Every trainable leaf of the network, in state-dict order."""
    out: Dict[str, tuple] = {}

    def block(p, ci, co, oned):
        k = (3,) if oned else (3, 3)
        one = (1,) if oned else (1, 1)
        for name, cin, kk in (("residual", ci, one), ("conv1", ci, k), ("conv2", co, k)):
            out[f"{p}.{name}.0.weight"] = (co, cin) + kk
            out[f"{p}.{name}.1.weight"] = (co,)
            out[f"{p}.{name}.1.bias"] = (co,)

    for name, (ci, co) in BLOCKS.items():
        if name == "spec_output_conv.0":
            continue
        if name == "mask_output_conv.0":
            out["conv_flatten.weight"] = (4, 32, 128, 1)
            out["conv_flatten.bias"] = (4,)
        block(name, ci, co, name == "mask_output_conv.0")
        if name == "conv9_1":
            block("spec_output_conv.0", 32, 32, False)
            out["spec_output_conv.1.weight"] = (2, 32, 1, 1)
            out["spec_output_conv.1.bias"] = (2,)
    out["mask_output_conv.1.weight"] = (1, 4, 1)
    out["mask_output_conv.1.bias"] = (1,)
    return out
