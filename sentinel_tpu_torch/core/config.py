"""Layered static configuration (the port's copy of
``sentinel_tpu/core/config.py``, the analog of ``SentinelConfig.java:54`` +
``SentinelConfigLoader``).

Resolution order (highest wins), mirroring the reference's JVM-props-over-file:
1. explicit ``set()`` calls
2. environment variables: ``CSP_SENTINEL_<KEY>`` with dots → underscores
3. a properties file (``SENTINEL_TPU_CONFIG`` env var, else ``~/.sentinel_tpu.properties``)
4. built-in defaults

Keys keep the reference's ``csp.sentinel.*`` names where one exists so operators
can carry configs across.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional


_DEFAULTS: Dict[str, str] = {
    # reference: SentinelConfig.java:60-70
    "csp.sentinel.app.name": "",
    "csp.sentinel.app.type": "0",
    "csp.sentinel.metric.file.single.size": str(50 * 1024 * 1024),
    "csp.sentinel.metric.file.total.count": "6",
    "csp.sentinel.flow.cold.factor": "3",
    "csp.sentinel.statistic.max.rt": "5000",
    # this build's additions (no reference key)
    "sentinel.tpu.engine.max.resources": "4096",
    "sentinel.tpu.engine.batch.size": "1024",
    "sentinel.tpu.server.port": "18730",
    "sentinel.tpu.server.idle.seconds": "600",
    "csp.sentinel.api.port": "8719",
    "csp.sentinel.heartbeat.interval.ms": "10000",
    # cluster HA: endpoint circuit breaker + failover
    "sentinel.tpu.ha.failure.threshold": "3",
    "sentinel.tpu.ha.backoff.base.ms": "100",
    "sentinel.tpu.ha.backoff.max.ms": "10000",
    "sentinel.tpu.ha.backoff.jitter": "0.2",
    "sentinel.tpu.ha.failover.deadline.ms": "500",
    "sentinel.tpu.ha.snapshot.period.s": "30",
    # client reconnect backoff (cluster.client.TokenClient)
    "sentinel.tpu.client.reconnect.base.s": "0.1",
    "sentinel.tpu.client.reconnect.max.s": "30",
    # Envoy RLS behavior when the token service errors: allow | deny
    "csp.sentinel.rls.failure.mode": "allow",
}


class SentinelConfig:
    """Process-global property registry. Thread-safe."""

    _lock = threading.RLock()
    _props: Dict[str, str] = {}  # explicit set() layer only
    _file_props: Dict[str, str] = {}  # file layer, below env
    _file_loaded = False

    @classmethod
    def _load_file_once(cls) -> None:
        if cls._file_loaded:
            return
        cls._file_loaded = True
        path = os.environ.get(
            "SENTINEL_TPU_CONFIG", os.path.expanduser("~/.sentinel_tpu.properties")
        )
        if not os.path.isfile(path):
            return
        try:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#") or "=" not in line:
                        continue
                    k, _, v = line.partition("=")
                    cls._file_props.setdefault(k.strip(), v.strip())
        except OSError:
            pass

    @classmethod
    def get(cls, key: str, default: Optional[str] = None) -> Optional[str]:
        with cls._lock:
            if key in cls._props:
                return cls._props[key]
            env_key = "CSP_SENTINEL_" + key.replace("csp.sentinel.", "").replace(
                "sentinel.tpu.", "TPU_"
            ).replace(".", "_").upper()
            if env_key in os.environ:
                return os.environ[env_key]
            cls._load_file_once()
            if key in cls._file_props:
                return cls._file_props[key]
            if key in _DEFAULTS:
                return _DEFAULTS[key]
            return default

    @classmethod
    def set(cls, key: str, value: str) -> None:
        with cls._lock:
            cls._props[key] = str(value)

    @classmethod
    def get_int(cls, key: str, default: int = 0) -> int:
        v = cls.get(key)
        try:
            return int(v) if v is not None else default
        except ValueError:
            return default

    @classmethod
    def get_float(cls, key: str, default: float = 0.0) -> float:
        v = cls.get(key)
        try:
            return float(v) if v is not None else default
        except ValueError:
            return default

    @classmethod
    def get_bool(cls, key: str, default: bool = False) -> bool:
        v = cls.get(key)
        if v is None:
            return default
        return v.strip().lower() in ("1", "true", "yes", "on")

    @classmethod
    def app_name(cls) -> str:
        return (
            cls.get("csp.sentinel.app.name")
            or os.environ.get("SENTINEL_APP_NAME")
            or "sentinel-tpu-app"
        )

    @classmethod
    def cold_factor(cls) -> int:
        # reference: SentinelConfig.java COLD_FACTOR, floor of 1 applied by WarmUpController
        return max(2, cls.get_int("csp.sentinel.flow.cold.factor", 3))

    @classmethod
    def max_rt(cls) -> int:
        return cls.get_int("csp.sentinel.statistic.max.rt", 5000)

    @classmethod
    def reset_for_tests(cls) -> None:
        with cls._lock:
            cls._props.clear()
            cls._file_props.clear()
            cls._file_loaded = False
