"""Training: the host trainer from recordings (``fit.fit``) and the
on-device synthetic trainer (``fit_synthetic``), their batch builders, loss,
optimizer and step.  ``train.fit`` stays the module (the JAX package's
``train.fit`` is the function); import the trainer as
``from softspoken_tpu_torch.train.fit import fit``."""

from . import augment, data, targets
from .fit import fit_synthetic, list_wavs
from .loop import TrainState, create_train_state, loss_fn, train_step

__all__ = ["augment", "data", "targets", "fit_synthetic", "list_wavs",
           "TrainState", "create_train_state", "loss_fn", "train_step"]
