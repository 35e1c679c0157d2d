from repro_torch.kernels.bitunpack import ops, ref
from repro_torch.kernels.bitunpack.ops import bitunpack, repack_for_device
from repro_torch.kernels.bitunpack.kernel import tpu_width

__all__ = ["ops", "ref", "bitunpack", "repack_for_device", "tpu_width"]
