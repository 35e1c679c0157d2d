from repro_torch.kernels.adv_gather import ops, ref
from repro_torch.kernels.adv_gather.ops import (FusedTables, adv_gather,
                                                adv_gather_packed,
                                                adv_gather_packed_rows,
                                                fuse_tables,
                                                gather_fused_parts)

__all__ = ["ops", "ref", "FusedTables", "adv_gather", "adv_gather_packed",
           "adv_gather_packed_rows", "fuse_tables", "gather_fused_parts"]
