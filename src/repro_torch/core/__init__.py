from repro_torch.core.features import (FEATURE_NAMES, FeatureExtractor,
                                       FeatureScales)
from repro_torch.core.linucb import LinUCBArm, LinUCBBank
from repro_torch.core.monitor import TelemetryMonitor, aggregate_snapshots
from repro_torch.core.page_hinkley import (ConvergenceConfig,
                                           ConvergenceDetector, PageHinkley)
from repro_torch.core.pruning import PruningConfig, PruningFramework
from repro_torch.core.refinement import (MixedMaturityRefinement,
                                         RefinementConfig)
from repro_torch.core.reward import RewardCalculator, RewardConfig
from repro_torch.core.tuner import AGFTConfig, AGFTTuner

__all__ = ["FEATURE_NAMES", "FeatureExtractor", "FeatureScales", "LinUCBArm",
           "LinUCBBank", "ConvergenceConfig", "ConvergenceDetector",
           "PageHinkley", "PruningConfig", "PruningFramework",
           "MixedMaturityRefinement", "RefinementConfig", "RewardCalculator",
           "RewardConfig", "AGFTConfig", "AGFTTuner", "TelemetryMonitor",
           "aggregate_snapshots"]
