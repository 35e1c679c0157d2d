from repro_torch.kernels.onehot_wide import ops, ref
from repro_torch.kernels.onehot_wide.ops import onehot_wide

__all__ = ["ops", "ref", "onehot_wide"]
