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
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
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


class ResBlock(nn.Module):
    """Residual conv block (pytorch_neural_nets.py:7-77), 2-D or 1-D.

    1×1 conv+BN shortcut; 3×3 conv-BN-ReLU, 3×3 conv-BN; add, ReLU.  The
    reference's Dropout after the add is inactive at inference.
    """

    def __init__(self, cin: int, cout: int, folded: bool = False, oned: bool = False):
        super().__init__()
        conv = nn.Conv1d if oned else nn.Conv2d
        bn = nn.BatchNorm1d if oned else nn.BatchNorm2d

        def seq(ci, k, pad):
            layers = [conv(ci, cout, k, padding=pad, bias=folded)]
            if not folded:
                layers.append(bn(cout, eps=BN_EPS))
            return nn.Sequential(*layers)

        self.residual = seq(cin, 1, 0)
        self.conv1 = seq(cin, 3, 1)
        self.conv2 = seq(cout, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = self.residual(x)
        out = F.relu(self.conv1(x))
        return F.relu(self.conv2(out) + identity)


def _up(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour ×2 upsample (nn.Upsample(mode='nearest'))."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class SpecUNet2D(nn.Module):
    """Input (B, 128, 256) log-mel; see ``forward`` and ``mask_logits``."""

    def __init__(self, folded: bool = False):
        super().__init__()
        self.folded = folded
        for name, (ci, co) in RES_BLOCK_SHAPES.items():
            if "." not in name:
                setattr(self, name, ResBlock(ci, co, folded))
        self.spec_output_conv = nn.Sequential(
            ResBlock(FILTERS, FILTERS, folded), nn.Conv2d(FILTERS, 2, 1))
        # Conv2d(32→4, kernel=(128, 1)): a VALID conv with one vertical
        # position, computed in _flatten as one contraction over (mel, channel)
        self.conv_flatten = nn.Conv2d(FILTERS, 4, (N_MELS, 1))
        self.mask_output_conv = nn.Sequential(
            ResBlock(4, 4, folded, oned=True), nn.Conv1d(4, 1, 1))

    def _trunk(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, 128, 256) → conv9 features (B, 32, 128, 256)."""
        dtype = self.conv1_1.conv1[0].weight.dtype
        x = mel.to(dtype).unsqueeze(1)
        conv1 = self.conv1_1(x)
        conv2 = self.conv2_1(F.max_pool2d(conv1, 2))
        conv3 = self.conv3_1(F.max_pool2d(conv2, 2))
        conv4 = self.conv4_1(F.max_pool2d(conv3, 2))
        enc = self.encoder_out(self.conv_bottleneck(F.max_pool2d(conv4, 2)))
        # decoder: concat order [skip, up] as torch.cat([skip, up], dim=1)
        conv6 = self.conv6(torch.cat([conv4, _up(enc)], 1))
        conv7 = self.conv7(torch.cat([conv3, _up(conv6)], 1))
        conv8 = self.conv8(torch.cat([conv2, _up(conv7)], 1))
        return self.conv9_1(torch.cat([conv1, _up(conv8)], 1))

    def _mask_head(self, conv9: torch.Tensor) -> torch.Tensor:
        w = self.conv_flatten.weight[..., 0]                     # (4, 32, 128)
        flat = torch.einsum("bcht,och->bot", conv9, w)
        flat = F.relu(flat + self.conv_flatten.bias[None, :, None])
        m = self.mask_output_conv(flat)                           # (B, 1, 256)
        return m[:, 0].to(torch.float32)

    def mask_logits(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, 128, 256) → raw per-frame speech logits (B, 256) float32."""
        return self._mask_head(self._trunk(mel))

    def forward(self, mel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 128, 256) → (spec (B, 2, 128, 256), mask logits (B, 256)),
        both float32."""
        conv9 = self._trunk(mel)
        spec = F.relu(self.spec_output_conv(conv9)).to(torch.float32)
        return spec, self._mask_head(conv9)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
