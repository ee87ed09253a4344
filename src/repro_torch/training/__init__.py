from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update, init_adamw)
from repro_torch.training.train_loop import make_train_step, train

__all__ = ["AdamWConfig", "AdamWState", "adamw_update", "init_adamw",
           "make_train_step", "train", "save_checkpoint", "load_checkpoint"]
