from .edge_gather import gather_rows
from .gcn_norm import add_self_loops, gcn_norm
from .sampling_ops import gumbel_topk, uniform_topk
from .scatter import (required_band, scatter_add, scatter_add_sorted,
                      segment_sum_scalar)
from .score_sampled import score_head_sampled
from .segment import segment_max, segment_mean, segment_softmax, segment_sum
from .score_tiles import build_tile_index, score_head_tiles
from .spmm import spmm

__all__ = ["gather_rows", "add_self_loops", "gcn_norm", "gumbel_topk",
           "uniform_topk", "segment_sum", "segment_mean", "segment_max",
           "segment_softmax",
           "required_band", "scatter_add", "scatter_add_sorted",
           "segment_sum_scalar",
           "score_head_sampled", "build_tile_index", "score_head_tiles",
           "spmm"]
