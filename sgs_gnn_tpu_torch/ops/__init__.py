from .edge_gather import gather_rows
from .sampling_ops import gumbel_topk, uniform_topk
from .scatter import (required_band, scatter_add, scatter_add_sorted,
                      segment_sum_scalar)
from .score_sampled import score_head_sampled
from .score_tiles import build_tile_index, score_head_tiles
from .spmm import spmm

__all__ = ["gather_rows", "gumbel_topk", "uniform_topk",
           "required_band", "scatter_add", "scatter_add_sorted",
           "segment_sum_scalar",
           "score_head_sampled", "build_tile_index", "score_head_tiles",
           "spmm"]
