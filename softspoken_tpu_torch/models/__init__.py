"""The detector network and BatchNorm folding."""

from typing import Mapping

import numpy as np
import torch

from .fold import fold_state_dict
from .unet import SpecUNet2D, param_count

__all__ = ["SpecUNet2D", "fold_state_dict", "param_count", "build_model", "load_unfolded"]


def load_unfolded(model: SpecUNet2D, sd: Mapping[str, object]) -> SpecUNet2D:
    """Loads an unfolded reference-layout state dict (numpy or torch values)
    into an unfolded model as float32; the BN counters start at 0.  Raises
    on a missing or unexpected key."""
    state = {k: torch.as_tensor(np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v,
                                           np.float32))
             for k, v in sd.items()
             if not k.startswith("mel_spectrogram") and not k.endswith("num_batches_tracked")}
    for k in model.state_dict():
        if k.endswith("num_batches_tracked"):
            state[k] = torch.zeros((), dtype=torch.long)
    model.load_state_dict(state, strict=True)
    return model


def build_model(sd: Mapping[str, object], folded: bool = True) -> SpecUNet2D:
    """A float32 CPU ``SpecUNet2D`` in eval mode from an unfolded
    reference-layout state dict (numpy or torch values)."""
    if not folded:
        return load_unfolded(SpecUNet2D(folded=False), sd).eval()
    model = SpecUNet2D(folded=True)
    model.load_state_dict(fold_state_dict(
        {k: v for k, v in sd.items() if not k.startswith("mel_spectrogram")}), strict=True)
    return model.eval()
