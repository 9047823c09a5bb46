from repro_torch.training.optimizer import (OptConfig, adamw_init,
                                            adamw_update)
from repro_torch.training.train_step import (make_loss_fn, make_prefill_step,
                                             make_train_step)

__all__ = [
    "OptConfig", "adamw_init", "adamw_update", "make_loss_fn",
    "make_prefill_step", "make_train_step",
]
