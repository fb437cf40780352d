"""Control plane: command center (HTTP) + heartbeat (the port's copy of
``sentinel_tpu/transport``).

Analog of ``sentinel-transport`` — an embedded HTTP server exposing
``CommandHandler``-style endpoints (rule CRUD, metrics pull, node trees,
cluster mode) and a periodic heartbeat POST to the dashboard.
"""

from sentinel_tpu_torch.transport.command import CommandCenter, command_mapping
from sentinel_tpu_torch.transport.heartbeat import HeartbeatSender

__all__ = ["CommandCenter", "command_mapping", "HeartbeatSender"]
