from repro_torch.kernels.predicate_scan import ops, ref
from repro_torch.kernels.predicate_scan.ops import (PackedTerms, ScanTerm,
                                                    compact_rows,
                                                    masked_counts, pack_terms,
                                                    predicate_scan)

__all__ = ["ops", "ref", "PackedTerms", "ScanTerm", "compact_rows",
           "masked_counts", "pack_terms", "predicate_scan"]
