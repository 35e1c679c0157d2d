"""Hand-written CUDA kernels for Hopper (``sm_90a``), built at first use.

- ``adv_gather``     — packed words or int32 codes -> concatenated ADV
  feature rows, one direct gather per output element (unpack, clamp and
  lookup fused; no int32 code stream on the packed paths)
- ``predicate_scan`` — compiled predicate terms over the resident packed
  words -> selection mask and match count in one launch; bitmap compaction
- ``hist``           — masked per-code counts straight from the packed words
- ``onehot_wide``    — the wide half of Wide&Deep (a direct gather-sum over
  C categorical columns) and its scatter-add gradient
- ``packed_code.cuh`` — the packed word layout every kernel reads it by
- ``bitunpack``      — the device word widths (host helper only)
- ``launch``         — what every wrapper shares (checks, stream, errors)
"""
