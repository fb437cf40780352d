"""Cluster high availability: the state snapshot file and warm-standby
replication (the port's half of ``sentinel_tpu/ha``).

- :mod:`~sentinel_tpu_torch.ha.snapshot` — device→host state snapshot and
  restore, the artifact directory and the periodic :class:`SnapshotManager`.
- :mod:`~sentinel_tpu_torch.ha.replication` — warm-standby delta streaming:
  :class:`ReplicationSender` ships dirty counter rows every tick over wire
  rev 3; :class:`StandbyApplier` applies them behind a closed front door
  until promotion, bounding failover loss at one ship interval.

The documents and frames are the reference's byte for byte, so a primary of
either package replicates into a standby of either.

The reference package also exports the failover client, the local
fallback policy, the endpoint health tracker and ``ClusterStateManager``
(``failover``, ``fallback``, ``endpoints``, ``manager``). They sit on the
cluster client and the local engine, which are not ported yet, so they are
not here.
"""

from sentinel_tpu_torch.ha.replication import ReplicationSender, StandbyApplier
from sentinel_tpu_torch.ha.snapshot import (
    SNAPSHOT_VERSION,
    SnapshotManager,
    decode_snapshot,
    encode_snapshot,
    load_latest,
    restore_from_doc,
    restore_latest,
    save_snapshot,
    snapshot_to_doc,
)

__all__ = [
    "ReplicationSender",
    "StandbyApplier",
    "SNAPSHOT_VERSION",
    "SnapshotManager",
    "encode_snapshot",
    "decode_snapshot",
    "snapshot_to_doc",
    "restore_from_doc",
    "save_snapshot",
    "load_latest",
    "restore_latest",
]
