from repro_torch.core.predictor.cost_model import (A100_40G, HardwareSpec,
                                                   ModelProfile,
                                                   profile_from_arch,
                                                   synthetic_profile)
from repro_torch.core.predictor.features import (StageObservation,
                                                 featurize,
                                                 featurize_batch,
                                                 semantic_embedding)
from repro_torch.core.predictor.gbdt import GBDT, GBDTConfig
from repro_torch.core.predictor.isotonic import IsotonicCalibrator
from repro_torch.core.predictor.length_model import (BertMLPBaseline,
                                                     LinearBaseline, MLP,
                                                     MaestroPred,
                                                     MagnusBaseline,
                                                     PredictorConfig,
                                                     classification_metrics,
                                                     regression_metrics)

__all__ = ["A100_40G", "HardwareSpec", "ModelProfile", "profile_from_arch",
           "synthetic_profile", "StageObservation", "featurize",
           "featurize_batch", "semantic_embedding", "GBDT", "GBDTConfig",
           "IsotonicCalibrator", "BertMLPBaseline", "LinearBaseline", "MLP",
           "MaestroPred", "MagnusBaseline", "PredictorConfig",
           "classification_metrics", "regression_metrics"]
