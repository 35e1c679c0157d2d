from repro_torch.serve.classes import (LatencyHistogram, Overloaded,
                                       RequestClass, default_classes)
from repro_torch.serve.faults import (DeadlineExceeded, DeviceDown,
                                      DeviceHealth, FaultInjector,
                                      FaultPolicy, InjectedFault, ServeError,
                                      StreamBreaker)
from repro_torch.serve.feature_service import FeatureService
from repro_torch.serve.frontend import FeatureFrontend

__all__ = ["FeatureService", "FeatureFrontend",
           "RequestClass", "Overloaded", "LatencyHistogram",
           "default_classes", "FaultInjector",
           "FaultPolicy", "ServeError", "DeadlineExceeded", "InjectedFault",
           "StreamBreaker", "DeviceDown", "DeviceHealth"]
