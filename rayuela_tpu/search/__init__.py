"""ADC search + recall evaluation (reference layer L4)."""

from rayuela_tpu.search.codes import (build_codes_index, search_codes,
                                      search_codes_streamed)
from rayuela_tpu.search.linscan import (LinscanIndex, build_index,
                                        eval_recall, linscan_cq,
                                        linscan_lsq, linscan_opq,
                                        linscan_pq, scan_topk, search,
                                        search_streamed)
from rayuela_tpu.search.norms import get_norms_codebook, quantize_norms

__all__ = [
    "LinscanIndex", "build_codes_index", "build_index", "eval_recall",
    "get_norms_codebook", "linscan_cq", "linscan_lsq", "linscan_opq",
    "linscan_pq", "quantize_norms", "scan_topk", "search",
    "search_codes", "search_codes_streamed", "search_streamed",
]
