"""Training: the loss and the single-device train step."""

from .pipeline import valid_next_token_mask
from .train import lm_cross_entropy, make_train_step

__all__ = ["lm_cross_entropy", "make_train_step", "valid_next_token_mask"]
