"""Hand-written CUDA kernels for Hopper (``sm_90a``), built at first use.

- ``adv_gather``     — packed words or int32 codes -> concatenated ADV
  feature rows, one direct gather per output element (unpack, clamp and
  lookup fused; no int32 code stream on the packed paths); and one ADV
  table gathered by int32 codes of any shape (the Table 6 path)
- ``predicate_scan`` — compiled predicate terms over the resident packed
  words -> selection mask and match count in one launch; bitmap compaction
- ``hist``           — per-code counts of an int32 code stream (the count
  metadata of paper §6.2), and masked per-code counts straight from the
  packed words
- ``onehot_wide``    — the wide half of Wide&Deep (a direct gather-sum over
  C categorical columns) and its scatter-add gradient
- ``bitunpack``      — device-width packed words -> int32 codes; the device
  word widths and the host repack
- ``flash``          — flash attention's forward and backward (dQ, then
  dK/dV) on the tensor cores, for the LM path past 1,024 keys
- ``packed_code.cuh`` — the packed word layout every kernel reads it by
- ``launch``         — what every wrapper shares (checks, stream, errors)
- ``edge_cases``     — the inputs the kernels are held to on a card
"""
