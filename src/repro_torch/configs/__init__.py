from repro_torch.configs.base import (
    ArchConfig,
    SSMConfig,
    dtype_bytes,
    get_config,
    register,
)

__all__ = ["ArchConfig", "SSMConfig", "dtype_bytes", "get_config", "register"]
