"""Cluster high availability (the port's copy of ``sentinel_tpu/ha``):
failover client, local fallback, snapshots and replication.

- :mod:`~sentinel_tpu_torch.ha.endpoints` — per-endpoint health with
  exponential backoff + jitter and a half-open circuit breaker.
- :mod:`~sentinel_tpu_torch.ha.failover` — :class:`FailoverTokenClient`, an
  ordered-endpoint-list ``TokenService`` that evicts dead primaries.
- :mod:`~sentinel_tpu_torch.ha.fallback` — per-rule local degradation
  (pass / block / local-window throttle) riding ``local.flow`` controllers.
- :mod:`~sentinel_tpu_torch.ha.snapshot` — device→host state snapshot and
  restore, the artifact directory and the periodic :class:`SnapshotManager`.
- :mod:`~sentinel_tpu_torch.ha.manager` — :class:`ClusterStateManager`,
  runtime client/server/off transitions that rewire the slot chain live.
- :mod:`~sentinel_tpu_torch.ha.replication` — warm-standby delta streaming:
  :class:`ReplicationSender` ships dirty counter rows every tick over wire
  rev 3; :class:`StandbyApplier` applies them behind a closed front door
  until promotion, bounding failover loss at one ship interval.

The documents and frames are the reference's byte for byte, so a primary of
either package replicates into a standby of either.
"""

from sentinel_tpu_torch.ha.endpoints import Endpoint, EndpointHealth, HealthState
from sentinel_tpu_torch.ha.failover import FailoverTokenClient
from sentinel_tpu_torch.ha.fallback import (
    FallbackAction,
    FallbackRule,
    LocalFallbackPolicy,
)
from sentinel_tpu_torch.ha.manager import ClusterStateManager
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
    "Endpoint",
    "EndpointHealth",
    "HealthState",
    "FailoverTokenClient",
    "FallbackAction",
    "FallbackRule",
    "LocalFallbackPolicy",
    "ClusterStateManager",
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
