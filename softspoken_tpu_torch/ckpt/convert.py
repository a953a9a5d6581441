"""Weights: the reference ``.pth`` layout, the deterministic fixture, and the
carry-over of weights from the JAX package's Flax variables.

The port's modules use the reference's ``state_dict`` key set and layout
(``NNDetector.py:42-53``), so:

  * ``load_pth``            — ``{'model_state_dict', 'epoch'}`` via
    ``torch.load(weights_only=True)``
  * ``fixture_state_dict``  — the numpy-only random state dict; the same
    seed gives exactly the JAX package's ``fixture_variables(seed)``
  * ``from_flax_variables`` — ``{'params', 'batch_stats'}`` as numpy (Flax
    HWIO kernels) → the reference layout (OIHW)
  * ``save_pth``            — a model's state dict as a reference checkpoint
    that the JAX package's torch-free reader loads too
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..models.unet import RES_BLOCK_SHAPES
from ..ops import mel as melops

_1D_BLOCKS = {"mask_output_conv.0"}
# reference module path → Flax module names
_BLOCKS = {k: k for k in RES_BLOCK_SHAPES}
_BLOCKS.update({"spec_output_conv.0": "spec_res", "mask_output_conv.0": "mask_res"})
_SEQ = {"residual": "res_conv", "conv1": "conv1", "conv2": "conv2"}
_BN_OF = {"res_conv": "res_bn", "conv1": "bn1", "conv2": "bn2"}
_HEAD_CONVS = {
    "spec_output_conv.1": "spec_conv",
    "conv_flatten": "conv_flatten",
    "mask_output_conv.1": "mask_conv",
}


def _kaiming_uniform(rng, shape, fan_in):
    # torch Conv default: kaiming_uniform(a=sqrt(5)) ⇒ bound = 1/sqrt(fan_in)
    bound = 1.0 / np.sqrt(fan_in)
    return rng.uniform(-bound, bound, size=shape).astype(np.float32)


def fixture_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    """A reproducible random state dict with exactly torch's key set/layout.

    The draw order is the JAX package's ``ckpt.convert.fixture_state_dict``,
    so both packages build the same weights from the same seed.
    """
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}

    def add_conv(name, cin, cout, k):
        fan_in = cin * int(np.prod(k))
        sd[name + ".weight"] = _kaiming_uniform(rng, (cout, cin) + k, fan_in)

    def add_bn(name, c):
        sd[name + ".weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[name + ".bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[name + ".running_mean"] = rng.normal(0, 0.2, c).astype(np.float32)
        sd[name + ".running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[name + ".num_batches_tracked"] = np.asarray(100, np.int64)

    for blk, (cin, cout) in RES_BLOCK_SHAPES.items():
        k1, k3 = ((1,), (3,)) if blk in _1D_BLOCKS else ((1, 1), (3, 3))
        add_conv(f"{blk}.residual.0", cin, cout, k1)
        add_bn(f"{blk}.residual.1", cout)
        add_conv(f"{blk}.conv1.0", cin, cout, k3)
        add_bn(f"{blk}.conv1.1", cout)
        add_conv(f"{blk}.conv2.0", cout, cout, k3)
        add_bn(f"{blk}.conv2.1", cout)

    def add_biased_conv(name, cin, cout, k):
        add_conv(name, cin, cout, k)
        sd[name + ".bias"] = _kaiming_uniform(rng, (cout,), cin * int(np.prod(k)))

    add_biased_conv("spec_output_conv.1", 32, 2, (1, 1))
    add_biased_conv("conv_flatten", 32, 4, (128, 1))
    add_biased_conv("mask_output_conv.1", 4, 1, (1,))
    return sd


def _kernel_to_torch(w: np.ndarray) -> np.ndarray:
    """Flax HWIO / KIO → torch OIHW / OIK."""
    if w.ndim == 4:
        return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))
    if w.ndim == 3:
        return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))
    raise ValueError(f"unexpected conv kernel rank {w.ndim}")


def from_flax_variables(variables: Mapping) -> Dict[str, np.ndarray]:
    """Unfolded Flax ``{'params', 'batch_stats'}`` (numpy leaves) → the
    reference ``state_dict`` layout (float32 numpy)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}

    def f32(x):
        return np.asarray(x, np.float32)

    for blk_key, blk in _BLOCKS.items():
        for seq, conv in _SEQ.items():
            bn = _BN_OF[conv]
            sd[f"{blk_key}.{seq}.0.weight"] = _kernel_to_torch(f32(params[blk][conv]["kernel"]))
            sd[f"{blk_key}.{seq}.1.weight"] = f32(params[blk][bn]["scale"])
            sd[f"{blk_key}.{seq}.1.bias"] = f32(params[blk][bn]["bias"])
            sd[f"{blk_key}.{seq}.1.running_mean"] = f32(stats[blk][bn]["mean"])
            sd[f"{blk_key}.{seq}.1.running_var"] = f32(stats[blk][bn]["var"])
    for prefix, name in _HEAD_CONVS.items():
        sd[f"{prefix}.weight"] = _kernel_to_torch(f32(params[name]["kernel"]))
        sd[f"{prefix}.bias"] = f32(params[name]["bias"])
    return sd


def model_keys(sd: Mapping[str, object]) -> Dict[str, object]:
    """Drop the entries a reference checkpoint carries beside the network:
    the torchaudio frontend buffers (``mel_spectrogram.*``, rebuilt in
    ``ops.mel``) and the BN ``num_batches_tracked`` counters."""
    return {k: v for k, v in sd.items()
            if not k.startswith("mel_spectrogram") and not k.endswith("num_batches_tracked")}


def load_pth(path: str) -> Tuple[Dict[str, object], int]:
    """Reference checkpoint ``{'model_state_dict', 'epoch'}`` → (state_dict, epoch)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "model_state_dict" not in ckpt:
        raise IOError(f"{path}: not a reference checkpoint "
                      "(expected a dict with 'model_state_dict')")
    return model_keys(ckpt["model_state_dict"]), int(ckpt.get("epoch", -1))


def mel_buffers() -> Dict[str, np.ndarray]:
    """The torchaudio frontend buffers a reference checkpoint carries
    (``pytorch_neural_nets.py:92-99``)."""
    return {
        "mel_spectrogram.spectrogram.window":
            melops.hann_periodic(melops.WIN_LENGTH).astype(np.float32),
        "mel_spectrogram.mel_scale.fb": melops.mel_filterbank(),
    }


def save_pth(path: str, state_dict: Mapping[str, object], epoch: int = -1) -> None:
    """Write ``{'model_state_dict', 'epoch'}`` (``NNDetector.py:47-49``).

    The state dict keeps its BN ``num_batches_tracked`` counters and gains
    the ``mel_spectrogram.*`` buffers, as the JAX package's ``export_pth``
    writes them.  Every tensor is saved from the CPU, contiguous, in a plain
    dict, so that the JAX package's torch-free reader loads the file.  The
    write goes to a temporary file in the same directory, then
    ``os.replace``: a reader never sees half a checkpoint.
    """
    sd = {k: torch.as_tensor(v).detach().cpu().contiguous()
          for k, v in {**mel_buffers(), **dict(state_dict)}.items()}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save({"model_state_dict": sd, "epoch": int(epoch)}, f)
            f.flush()
            os.fsync(f.fileno())
        os.chmod(tmp, 0o644)  # mkstemp's 0600 would hide the file from other users
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
