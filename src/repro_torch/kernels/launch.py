"""What every kernel wrapper shares: argument checks, the launch stream, the
device rule and the launch-error check.

A wrapper checks each tensor with :func:`check`, asks :func:`device_kind`
whether to run the plain version (``"cpu"``) or launch (``"cuda"``), passes
:func:`stream_ptr` to the launcher, and hands the launcher's return code to
:func:`raise_on`.
"""
from __future__ import annotations

import torch


def check(name: str, t: torch.Tensor, dtype, ndim: int,
          device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-D ``dtype`` tensor on
    ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the launchers take it."""
    return torch.cuda.current_stream(device).cuda_stream


def raise_on(err: int, error_string, name: str) -> None:
    """Raise if a launcher returned a nonzero ``cudaError_t``;
    ``error_string`` is the library's own ``cudaGetErrorString``."""
    if err:
        msg = error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} "
                           f"(cudaError {err})")


def device_kind(device: torch.device) -> str:
    """``"cpu"`` (run the plain version) or ``"cuda"`` (launch)."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and device.index not in (None, 0):
        # the launchers run on their own (static) CUDA runtime, whose
        # current device is 0 in every thread; multi-device serving must
        # pass the device into the launcher first
        raise ValueError(f"the kernels launch on cuda:0 only, got {device}")
    return device.type
