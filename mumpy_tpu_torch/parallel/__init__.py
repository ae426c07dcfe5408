"""Data parallelism: one process per card under ``torchrun``, the batch rows
sharded over the ranks, the gradients averaged (:mod:`.dist`)."""

from .dist import (Dist, all_reduce_mean, broadcast_tensors, init_from_env, row_shard,
                   serving_devices)

__all__ = ["Dist", "init_from_env", "row_shard", "all_reduce_mean", "broadcast_tensors",
           "serving_devices"]
