"""Training: the on-device synthetic trainer (``fit_synthetic``), its batch
synthesizer, loss, optimizer and step."""

from .fit import fit_synthetic
from .loop import TrainState, create_train_state, loss_fn, train_step

__all__ = ["fit_synthetic", "TrainState", "create_train_state", "loss_fn", "train_step"]
