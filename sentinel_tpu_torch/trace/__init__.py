"""Flight-recorder tracing, black-box dumps, and the per-tenant SLO plane
(the port's copy of ``sentinel_tpu/trace``).

- :mod:`~sentinel_tpu_torch.trace.ring` — per-thread fixed-size struct
  rings of ``(t_ns, stage, xid, shard, aux)`` events, fed by every hop of
  the front door and the control paths, and of step spans (start, end,
  parent, step id) inside the service step, the param step and the door's
  control lane.
- :mod:`~sentinel_tpu_torch.trace.spans` — xid-hash-sampled end-to-end
  spans assembled on demand across rings.
- :mod:`~sentinel_tpu_torch.trace.blackbox` — atomic post-mortem dumps
  (rings + metrics + config fingerprint) on brownout escalation or
  operator command.
- :mod:`~sentinel_tpu_torch.trace.slo` — per-namespace latency
  histograms, 1m/1h burn rates vs the p99 objective, and per-tenant shed
  attribution.
"""

from sentinel_tpu_torch.trace import blackbox, ring, slo, spans
from sentinel_tpu_torch.trace.ring import arm, disarm, record, sample_xid
from sentinel_tpu_torch.trace.slo import merge_fleet, slo_plane

__all__ = [
    "ring",
    "spans",
    "blackbox",
    "slo",
    "arm",
    "disarm",
    "record",
    "sample_xid",
    "slo_plane",
    "merge_fleet",
]
