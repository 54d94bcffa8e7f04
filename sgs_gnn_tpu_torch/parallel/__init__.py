from .mesh import (Mesh, backend_for, device_count, make_dp_tp_mesh,
                   make_mesh, rank_seed)
from .distributed import init_distributed, is_primary, local_slot_indices
from .partitioned import make_parallel_eval_step, make_parallel_train_step
from .halo_train import (Exchange, HaloBatch, build_halo_batch,
                         halo_full_forward, make_halo_eval_step,
                         make_halo_train_step)
from .tensor_parallel import (gather_params_tp, is_sharded,
                              shard_params_tp, tp_param_spec)

__all__ = ["Mesh", "backend_for", "device_count", "make_mesh",
           "make_dp_tp_mesh", "rank_seed",
           "init_distributed", "is_primary", "local_slot_indices",
           "make_parallel_train_step", "make_parallel_eval_step",
           "Exchange", "HaloBatch", "build_halo_batch", "halo_full_forward",
           "make_halo_train_step", "make_halo_eval_step",
           "shard_params_tp", "gather_params_tp", "tp_param_spec",
           "is_sharded"]
