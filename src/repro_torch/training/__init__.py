"""Training for the port (counterpart of `repro.training`): the synthetic
data pipeline, AdamW, the train step and atomic checkpoints."""
from repro_torch.training.checkpoint import (latest_step, restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.data import SyntheticDataPipeline
from repro_torch.training.optimizer import adamw_init, adamw_update, global_norm
from repro_torch.training.train import TrainConfig, make_train_step

__all__ = ["adamw_init", "adamw_update", "global_norm", "make_train_step",
           "TrainConfig", "SyntheticDataPipeline", "save_checkpoint",
           "restore_checkpoint", "latest_step"]
