"""repro_torch.train — the train step, the trainer and sharded
checkpoints with restart: the port of the JAX package's ``train``."""
from repro_torch.train.checkpoint import (latest_step,  # noqa: F401
                                          load_checkpoint, save_checkpoint)
from repro_torch.train.trainer import Trainer, make_train_step  # noqa: F401
