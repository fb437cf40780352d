"""Heartbeat: periodic registration POST to the dashboard (the port's copy
of ``sentinel_tpu/transport/heartbeat.py``).

Analog of ``HeartbeatSender.java:35`` / ``HeartbeatSenderInitFunc.java:38-91``
/ ``SimpleHttpHeartbeatSender``: POST ``/registry/machine`` with app/ip/port/
version on an interval (``csp.sentinel.heartbeat.interval.ms``); multiple
dashboard addresses are tried in order.
"""

from __future__ import annotations

import json
import random
import socket
import threading
import urllib.request
from typing import List, Optional

import sentinel_tpu_torch
from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.core.config import SentinelConfig
from sentinel_tpu_torch.core.log import record_log


class HeartbeatSender:
    def __init__(
        self,
        dashboard_addrs: Optional[List[str]] = None,
        command_port: Optional[int] = None,
        interval_ms: Optional[int] = None,
        client_ip: Optional[str] = None,
    ):
        raw = SentinelConfig.get("csp.sentinel.dashboard.server") or ""
        self.addrs = dashboard_addrs or [a for a in raw.split(",") if a]
        # csp.sentinel.heartbeat.client.ip (TransportConfig): pin the
        # advertised IP when the auto-detected one isn't routable
        self.client_ip = client_ip or SentinelConfig.get(
            "csp.sentinel.heartbeat.client.ip"
        )
        # keys keep the reference's names (TransportConfig.java:35-41)
        self.command_port = command_port or SentinelConfig.get_int(
            "csp.sentinel.api.port", 8719
        )
        self.interval_ms = interval_ms or SentinelConfig.get_int(
            "csp.sentinel.heartbeat.interval.ms", 10_000
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._consecutive_failures = 0

    def _payload(self) -> bytes:
        return json.dumps(
            {
                "app": SentinelConfig.app_name(),
                "app_type": SentinelConfig.get_int("csp.sentinel.app.type", 0),
                "hostname": socket.gethostname(),
                "ip": self.client_ip or _local_ip(),
                "port": self.command_port,
                "version": f"sentinel-tpu/{sentinel_tpu_torch.__version__}",
                "timestamp": _clock.now_ms(),
            }
        ).encode()

    def send_once(self) -> bool:
        payload = self._payload()
        for addr in self.addrs:
            url = f"http://{addr}/registry/machine"
            try:
                req = urllib.request.Request(
                    url, data=payload,
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=3) as rsp:
                    if 200 <= rsp.status < 300:
                        return True
            except Exception as e:
                record_log.debug("heartbeat to %s failed: %s", addr, e)
        return False

    def start(self) -> "HeartbeatSender":
        if not self.addrs:
            record_log.info("no dashboard configured; heartbeat disabled")
            return self
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="sentinel-heartbeat"
        )
        self._thread.start()
        return self

    def _interval_s(self) -> float:
        """Next wait. A dead dashboard is probed on an exponentially
        growing interval (doubling per consecutive failure, capped at 10×)
        with ±25% jitter so a fleet that lost its dashboard together
        doesn't re-register in one synchronized thundering herd; one
        success snaps back to the configured cadence."""
        base = self.interval_ms / 1000.0
        if self._consecutive_failures == 0:
            return base
        backoff = min(base * (2.0 ** self._consecutive_failures), base * 10.0)
        return backoff * random.uniform(0.75, 1.25)

    def _loop(self) -> None:
        while not self._stop.wait(self._interval_s()):
            if self.send_once():
                self._consecutive_failures = 0
            else:
                self._consecutive_failures += 1

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)


def _local_ip() -> str:
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return "127.0.0.1"
