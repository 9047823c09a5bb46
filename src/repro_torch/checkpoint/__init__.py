from repro_torch.checkpoint.checkpoint import (latest_step, prune, restore,
                                               save)

__all__ = ["latest_step", "prune", "restore", "save"]
