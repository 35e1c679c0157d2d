from repro_torch.kernels.flash import ops

__all__ = ["ops"]
