from repro_torch.kernels.hist import ops, ref
from repro_torch.kernels.hist.ops import masked_counts

__all__ = ["ops", "ref", "masked_counts"]
