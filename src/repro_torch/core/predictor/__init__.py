from repro_torch.core.predictor.cost_model import (HardwareSpec,
                                                   ModelProfile,
                                                   profile_from_arch)

__all__ = ["HardwareSpec", "ModelProfile", "profile_from_arch"]
