"""Training of the port: optimizer, train step, checkpoints (the
reference's ``training/``), on every stack the port registers."""
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update, cosine_lr
from repro_torch.training.train_step import loss_fn, make_train_step

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "cosine_lr",
    "loss_fn",
    "make_train_step",
    "load_checkpoint",
    "save_checkpoint",
]
