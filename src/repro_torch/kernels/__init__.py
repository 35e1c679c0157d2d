"""Hand-written CUDA kernels for Hopper (``sm_90a``), built at first use.

- ``adv_gather`` — packed words or int32 codes -> concatenated ADV feature
  rows, one direct gather per output element (unpack, clamp and lookup
  fused; no int32 code stream on the packed paths)
- ``bitunpack``  — the device word widths (host helper only)
"""
