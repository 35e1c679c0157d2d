from repro_torch.serve.classes import (LatencyHistogram, RequestClass,
                                       default_classes)
from repro_torch.serve.faults import DeadlineExceeded, ServeError
from repro_torch.serve.feature_service import FeatureService

__all__ = ["FeatureService", "RequestClass", "LatencyHistogram",
           "default_classes", "ServeError", "DeadlineExceeded"]
