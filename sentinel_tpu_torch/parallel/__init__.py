"""Scale-out: the flow axis sharded over a mesh of shards.

Port of ``sentinel_tpu/parallel``. Resource parallelism (independent
counters per flowId) is the flow axis cut into shards; namespace parallelism
stays a partition of that axis. The host splits each batch by owner, so a
shard steps only its own rows; the reference's XLA collectives become two
small psums a step (namespace counts by run, admitted rows by namespace)
and a pmax over the occupy ring between one thread per shard, while the
``[flows, buckets, events]`` counter tensors never leave their shard.
"""

from sentinel_tpu_torch.parallel.sharding import (
    make_flow_mesh,
    make_sharded_decide,
    shard_state,
    shard_rules,
)

__all__ = [
    "make_flow_mesh",
    "make_sharded_decide",
    "shard_state",
    "shard_rules",
]
