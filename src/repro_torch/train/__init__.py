"""Training/serving substrate (port of ``repro/train``): the train and
decode steps of every family on one device or sharded on an LM mesh, and
checkpoints that restore onto any mesh."""

from repro_torch.train.optimizer import AdamWConfig, init_opt_state, apply_adamw
from repro_torch.train.train_step import build_train_step, build_serve_step
from repro_torch.train.data import DataConfig, batch_at
from repro_torch.train.checkpoint import (
    save_checkpoint,
    restore_checkpoint,
    latest_step,
    install_preemption_handler,
)

__all__ = [
    "AdamWConfig",
    "init_opt_state",
    "apply_adamw",
    "build_train_step",
    "build_serve_step",
    "DataConfig",
    "batch_at",
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "install_preemption_handler",
]
