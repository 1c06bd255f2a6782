"""Data parallelism over processes (counterpart of contrastyou_tpu/parallel):
a step over W ranks, each holding 1/W of the global batch, computes what one
process computes on the whole batch (``mesh.py``, ``collectives.py``)."""
from .collectives import (all_reduce_sum, gather_rows, mean_over_ranks, num_ranks, sum_gradients,
                          sum_over_ranks)
from .mesh import (DataGroup, active_group, data_parallel, init_distributed, is_master,
                   multi_rank, replicate, shard_batch)

__all__ = ["DataGroup", "init_distributed", "is_master", "multi_rank", "shard_batch", "replicate",
           "data_parallel", "active_group", "all_reduce_sum", "num_ranks", "gather_rows",
           "sum_over_ranks", "sum_gradients", "mean_over_ranks"]
