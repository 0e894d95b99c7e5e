"""Multi-process parallelism over ``torch.distributed``
(``tpugan_tpu/parallel``): process groups, the batch split and
autograd-aware collectives (``mesh``), point-sharded neighbour ops
(``sharded_ops``) and point-sharded serving (``sharded_serving``). The
data-parallel train steps are ``train/step.py``'s with
``data_parallel=True``."""

from tpugan_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    all_gather,
    all_reduce,
    average_gradients,
    batch_sharded,
    initialize_distributed,
    rank,
    world_size,
)
from tpugan_tpu_torch.parallel.sharded_ops import (
    sharded_ball_query,
    sharded_chamfer,
    sharded_knn,
)
from tpugan_tpu_torch.parallel.sharded_serving import (
    make_sharded_rollout_step,
    rollout_sequence_sharded,
)

__all__ = [
    "DATA_AXIS",
    "all_gather",
    "all_reduce",
    "average_gradients",
    "batch_sharded",
    "initialize_distributed",
    "rank",
    "world_size",
    "sharded_ball_query",
    "sharded_chamfer",
    "sharded_knn",
    "make_sharded_rollout_step",
    "rollout_sequence_sharded",
]
