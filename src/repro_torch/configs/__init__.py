from repro_torch.configs.base import (
    SHAPES,
    ArchConfig,
    CrossAttnConfig,
    EncoderConfig,
    MoEConfig,
    SSMConfig,
    TensorSpec,
    all_cells,
    dtype_bytes,
    get_config,
    input_specs,
    list_configs,
    register,
)

__all__ = ["SHAPES", "ArchConfig", "CrossAttnConfig", "EncoderConfig",
           "MoEConfig", "SSMConfig", "TensorSpec", "all_cells",
           "dtype_bytes", "get_config", "input_specs", "list_configs",
           "register"]
