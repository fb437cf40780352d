"""One-shot environment init (analog of ``InitExecutor.doInit`` +
the transport/metric ``InitFunc`` set; the port's copy of
``sentinel_tpu/init.py``).

``init_default()`` starts, based on config:
- the HTTP command center (``CommandCenterInitFunc``)
- the heartbeat sender, if a dashboard address is configured
  (``HeartbeatSenderInitFunc``)
- the 1-second metric log aggregation (``MetricTimerListener`` scheduling —
  which the reference hangs off ``FlowRuleManager``'s static scheduler)

Returns the started components for lifecycle control. Python needs no
classpath magic, so this is an explicit call instead of a static block.
"""

from __future__ import annotations

import threading
from typing import Optional

from sentinel_tpu_torch.core.config import SentinelConfig
from sentinel_tpu_torch.metrics.log import MetricTimer
from sentinel_tpu_torch.transport.command import CommandCenter, ServerFactory
from sentinel_tpu_torch.transport.heartbeat import HeartbeatSender


class SentinelRuntime:
    def __init__(self, command_center=None, heartbeat=None, metric_timer=None):
        self.command_center: Optional[CommandCenter] = command_center
        self.heartbeat: Optional[HeartbeatSender] = heartbeat
        self.metric_timer: Optional[MetricTimer] = metric_timer

    def stop(self) -> None:
        if self.command_center is not None:
            self.command_center.stop()
        if self.heartbeat is not None:
            self.heartbeat.stop()
        if self.metric_timer is not None:
            self.metric_timer.stop()


_lock = threading.Lock()
_runtime: Optional[SentinelRuntime] = None


def init_default(
    command_port: Optional[int] = None,
    with_metric_log: bool = True,
    server_factory: Optional[ServerFactory] = None,
) -> SentinelRuntime:
    """Idempotent: the first call wires the runtime, later calls return it.
    ``server_factory`` goes to the command center: the door that
    ``setClusterMode`` mode 1 starts (None: the reference's
    ``DefaultTokenService()``, on the card)."""
    global _runtime
    with _lock:
        if _runtime is not None:
            return _runtime
        port = (
            command_port
            if command_port is not None
            else SentinelConfig.get_int("csp.sentinel.api.port", 8719)
        )
        cc = CommandCenter(port=port, server_factory=server_factory).start()
        hb = HeartbeatSender(command_port=cc.port).start()
        mt = MetricTimer().start() if with_metric_log else None
        _runtime = SentinelRuntime(cc, hb, mt)
        return _runtime


def shutdown() -> None:
    global _runtime
    with _lock:
        if _runtime is not None:
            _runtime.stop()
            _runtime = None
