from repro_torch.training.optimizer import (OptConfig, abstract_opt_state,
                                            adamw_init, adamw_update,
                                            opt_pspecs)
from repro_torch.training.train_step import (batch_pspecs, build_cell,
                                             make_decode_step, make_loss_fn,
                                             make_prefill_step,
                                             make_train_step)

__all__ = [
    "OptConfig", "abstract_opt_state", "adamw_init", "adamw_update",
    "batch_pspecs", "build_cell", "make_decode_step", "make_loss_fn",
    "make_prefill_step", "make_train_step", "opt_pspecs",
]
