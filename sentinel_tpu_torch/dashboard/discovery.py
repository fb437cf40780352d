"""Machine discovery: who is alive, per app.

Analog of ``discovery/SimpleMachineDiscovery.java`` + ``AppManagement`` +
``MachineInfo`` (heartbeat staleness marks machines dead, SURVEY.md §5).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from sentinel_tpu_torch.core import clock as _clock

HEARTBEAT_STALE_MS = 30_000  # reference marks dead after missed heartbeats


@dataclass
class MachineInfo:
    app: str
    ip: str
    port: int
    hostname: str = ""
    version: str = ""
    last_heartbeat_ms: int = 0

    @property
    def key(self) -> str:
        return f"{self.ip}:{self.port}"

    def healthy(self, now_ms: Optional[int] = None) -> bool:
        now = _clock.now_ms() if now_ms is None else now_ms
        return now - self.last_heartbeat_ms < HEARTBEAT_STALE_MS

    def to_dict(self) -> dict:
        return {
            "app": self.app,
            "ip": self.ip,
            "port": self.port,
            "hostname": self.hostname,
            "version": self.version,
            "lastHeartbeat": self.last_heartbeat_ms,
            "healthy": self.healthy(),
        }


class AppManagement:
    """app → {ip:port → MachineInfo}; single lock, registration idempotent."""

    def __init__(self):
        self._lock = threading.Lock()
        self._apps: Dict[str, Dict[str, MachineInfo]] = {}

    def register(self, machine: MachineInfo) -> None:
        if not machine.app or not machine.ip:
            raise ValueError("machine must carry app and ip")
        if machine.last_heartbeat_ms == 0:
            machine.last_heartbeat_ms = _clock.now_ms()
        with self._lock:
            self._apps.setdefault(machine.app, {})[machine.key] = machine

    def apps(self) -> List[str]:
        with self._lock:
            return sorted(self._apps)

    def machines(self, app: str) -> List[MachineInfo]:
        with self._lock:
            return list(self._apps.get(app, {}).values())

    def healthy_machines(self, app: str) -> List[MachineInfo]:
        now = _clock.now_ms()
        return [m for m in self.machines(app) if m.healthy(now)]

    def remove_app(self, app: str) -> None:
        with self._lock:
            self._apps.pop(app, None)

    def remove_machine(self, app: str, ip: str, port: int) -> bool:
        """Deregister one machine; drops the app when it was the last one."""
        key = f"{ip}:{port}"
        with self._lock:
            machines = self._apps.get(app)
            if machines is None or machines.pop(key, None) is None:
                return False
            if not machines:
                self._apps.pop(app, None)
            return True
