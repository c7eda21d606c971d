"""Data parallelism over ``torch.distributed`` (``parallel/mesh.py``)."""

from pggan_tpu_torch.parallel.mesh import (
    Group,
    all_reduce_grads,
    all_reduce_sum,
    check_batch_divisible,
    fit_minibatch_to_mesh,
    gather_generator_states,
    global_mean,
    initialize_distributed,
    replicate,
    shard_batch,
)

__all__ = ["Group", "all_reduce_grads", "all_reduce_sum",
           "check_batch_divisible", "fit_minibatch_to_mesh",
           "gather_generator_states", "global_mean",
           "initialize_distributed", "replicate", "shard_batch"]
