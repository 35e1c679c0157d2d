from repro_torch.kernels.hist import ops, ref
from repro_torch.kernels.hist.ops import hist, masked_counts

__all__ = ["ops", "ref", "hist", "masked_counts"]
