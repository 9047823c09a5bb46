from repro_torch.configs.base import (
    ArchConfig,
    CrossAttnConfig,
    EncoderConfig,
    MoEConfig,
    SSMConfig,
    dtype_bytes,
    get_config,
    register,
)

__all__ = ["ArchConfig", "CrossAttnConfig", "EncoderConfig", "MoEConfig",
           "SSMConfig", "dtype_bytes", "get_config", "register"]
