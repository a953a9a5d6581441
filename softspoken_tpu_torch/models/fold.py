"""BatchNorm folding for inference, on a reference-layout state dict.

Every conv in a residual block is bias-free and followed by a BatchNorm
(pytorch_neural_nets.py:13-27, 49-63).  At inference BN is an affine map with
frozen statistics, so it folds into the conv:

    BN(conv(x)) = conv(x) · g + b,   g = γ/√(σ²+ε),  b = β − μ·g
    ⇒ weight' = weight · g[out],  bias' = b

computed in float64 and stored as float32, as the JAX package's
``models/fold.py`` does.  The result loads into ``SpecUNet2D(folded=True)``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .unet import BN_EPS, RES_BLOCK_SHAPES

_SEQS = ("residual", "conv1", "conv2")
_HEAD_CONVS = ("spec_output_conv.1", "conv_flatten", "mask_output_conv.1")


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def fold_state_dict(sd: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """Unfolded reference-layout state dict (numpy or torch values) →
    folded state dict of float32 CPU tensors."""
    out: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        out[key] = torch.from_numpy(np.asarray(arr, np.float32))

    for blk in RES_BLOCK_SHAPES:
        for seq in _SEQS:
            conv, bn = f"{blk}.{seq}.0", f"{blk}.{seq}.1"
            g = _f64(sd[bn + ".weight"]) / np.sqrt(_f64(sd[bn + ".running_var"]) + BN_EPS)
            w = _f64(sd[conv + ".weight"])
            put(conv + ".weight", w * g.reshape((-1,) + (1,) * (w.ndim - 1)))
            put(conv + ".bias", _f64(sd[bn + ".bias"]) - _f64(sd[bn + ".running_mean"]) * g)
    for name in _HEAD_CONVS:
        put(name + ".weight", _f64(sd[name + ".weight"]))
        put(name + ".bias", _f64(sd[name + ".bias"]))
    return out
