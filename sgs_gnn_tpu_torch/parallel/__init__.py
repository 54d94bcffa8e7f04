from .mesh import Mesh, backend_for, device_count, make_mesh, rank_seed
from .distributed import init_distributed, is_primary, local_slot_indices
from .partitioned import make_parallel_eval_step, make_parallel_train_step
from .halo_train import (Exchange, HaloBatch, build_halo_batch,
                         halo_full_forward, make_halo_eval_step,
                         make_halo_train_step)

__all__ = ["Mesh", "backend_for", "device_count", "make_mesh", "rank_seed",
           "init_distributed", "is_primary", "local_slot_indices",
           "make_parallel_train_step", "make_parallel_eval_step",
           "Exchange", "HaloBatch", "build_halo_batch", "halo_full_forward",
           "make_halo_train_step", "make_halo_eval_step"]
