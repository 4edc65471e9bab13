"""LM training (``repro/train``): AdamW, the train step and the
fault-tolerant ``Trainer``."""
from repro_torch.train.optimizer import (  # noqa: F401
    AdamWConfig, adamw_init_decls, adamw_update, sgd_update,
)
from repro_torch.train.steps import make_train_step  # noqa: F401
