from repro_torch.configs.base import (
    ArchConfig,
    dtype_bytes,
    get_config,
    register,
)

__all__ = ["ArchConfig", "dtype_bytes", "get_config", "register"]
