from repro_torch.configs.base import (
    ArchConfig,
    MoEConfig,
    SSMConfig,
    dtype_bytes,
    get_config,
    register,
)

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "dtype_bytes",
           "get_config", "register"]
