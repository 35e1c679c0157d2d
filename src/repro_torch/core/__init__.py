"""The paper's primary contribution: Augmented Dictionary Values (ADVs).

- :mod:`repro_torch.core.adv` — ADV columns attached to columnar dictionaries
- :mod:`repro_torch.core.feature_spec` — declarative featurization specs
  (Table 6)
- :mod:`repro_torch.core.pipeline` — FeaturePlan / FeatureExecutor /
  FeaturePipeline: columnar table -> device feature batches via the ADV
  gather kernels (minimal data movement)
- :mod:`repro_torch.core.feedback` — learned artifacts written back as
  ADVs (paper §7)
- :mod:`repro_torch.core.cycle` — the §7 analytics cycle on a device
"""
from repro_torch.core.adv import AugmentedDictionary, ADV
from repro_torch.core.feature_spec import FeatureSpec, FeatureSet
from repro_torch.core.pipeline import (FeatureExecutor, FeaturePipeline,
                                       FeaturePlan, plan_from_reference)

__all__ = ["AugmentedDictionary", "ADV", "FeatureSpec", "FeatureSet",
           "FeaturePipeline", "FeaturePlan", "FeatureExecutor",
           "plan_from_reference"]
