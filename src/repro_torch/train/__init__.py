from repro_torch.train.fault import StragglerDetector

__all__ = ["StragglerDetector"]
