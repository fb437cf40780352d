"""etcd v3 datasource (analog of ``sentinel-datasource-etcd``).

Speaks the etcd v3 JSON/gRPC-gateway API directly: ``POST /v3/kv/range``
with base64 keys. Like the reference's jetcd ``Watch``
(``EtcdDataSource.java``), changes propagate through a real watch: a
``POST /v3/watch`` whose chunked response streams newline-delimited JSON
events, consumed incrementally with ``http.client`` (urllib can't). A
cheap ``mod_revision`` poll (keys-only range) stays on as the backstop, so
a dropped watch stream degrades to bounded staleness instead of silence.
"""

from __future__ import annotations

import base64
import http.client
import json
import threading
import urllib.parse
from typing import Optional

from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.datasource.base import AutoRefreshDataSource, Converter
from sentinel_tpu_torch.datasource.http_util import request

# one watch-stream JSON line (rule payloads are KBs; 16MB is generous)
_MAX_WATCH_LINE = 16 * 1024 * 1024


def _b64(s: str) -> str:
    return base64.b64encode(s.encode()).decode()


class EtcdDataSource(AutoRefreshDataSource):
    def __init__(
        self,
        converter: Converter,
        endpoint: str = "http://127.0.0.1:2379",
        rule_key: str = "sentinel/rules",
        refresh_interval_s: float = 1.0,
        user: Optional[str] = None,
        password: Optional[str] = None,
        watch: bool = True,
    ):
        self.endpoint = endpoint.rstrip("/")
        self.rule_key = rule_key
        self._auth_token: Optional[str] = None
        self._user, self._password = user, password
        self._last_mod_rev: Optional[int] = None
        self.watch = watch
        self._watch_thread: Optional[threading.Thread] = None
        self._watch_conn: Optional[http.client.HTTPConnection] = None
        self._watch_stop = threading.Event()
        super().__init__(converter, refresh_interval_s)

    def start(self) -> "EtcdDataSource":
        super().start()
        if self.watch:
            self._watch_thread = threading.Thread(
                target=self._watch_loop, daemon=True,
                name="sentinel-etcd-watch",
            )
            self._watch_thread.start()
        return self

    def close(self) -> None:
        self._watch_stop.set()
        conn = self._watch_conn
        if conn is not None:
            try:
                # shutdown (not just close) — closing an fd from another
                # thread does not reliably wake a blocked recv on Linux,
                # but SHUT_RDWR makes the reader's recv return 0 at once
                if conn.sock is not None:
                    import socket as _socket

                    conn.sock.shutdown(_socket.SHUT_RDWR)
                conn.close()
            except Exception:
                pass
        super().close()
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=2)
            self._watch_thread = None

    # -- watch stream -------------------------------------------------------
    def _watch_loop(self) -> None:
        """Consume ``POST /v3/watch``'s chunked stream; each events message
        triggers an immediate refresh. Any failure falls back to the poll
        loop's bounded staleness and reconnects after one interval."""
        parsed = urllib.parse.urlsplit(self.endpoint)
        conn_cls = (
            http.client.HTTPSConnection
            if parsed.scheme == "https" else http.client.HTTPConnection
        )
        while not self._watch_stop.is_set():
            conn = None
            try:
                # idle streams carry no bytes; the read timeout doubles as
                # a liveness bound after which we just re-establish
                conn = conn_cls(
                    parsed.hostname, parsed.port or 2379, timeout=60.0
                )
                # publish the conn BEFORE any blocking I/O (the constructor
                # doesn't connect) so close() can always interrupt us
                self._watch_conn = conn
                if self._watch_stop.is_set():
                    break
                headers = {"Content-Type": "application/json"}
                headers.update(self._headers())
                conn.request(
                    "POST", "/v3/watch",
                    body=json.dumps(
                        {"create_request": {"key": _b64(self.rule_key)}}
                    ),
                    headers=headers,
                )
                resp = conn.getresponse()
                if resp.status in (401, 403) and self._user:
                    # expired simple token: drop it so the next reconnect
                    # re-authenticates (same repair _range does) instead of
                    # silently degrading to poll-interval staleness
                    self._auth_token = None
                if resp.status != 200:
                    raise RuntimeError(f"watch HTTP {resp.status}")
                while not self._watch_stop.is_set():
                    # bounded read: a misbehaving gateway streaming one huge
                    # line must fail the stream (→ reconnect), not exhaust
                    # process memory (r4 advisor)
                    line = resp.readline(_MAX_WATCH_LINE + 1)
                    if not line:
                        break  # stream closed by server
                    if len(line) > _MAX_WATCH_LINE:
                        raise RuntimeError(
                            f"watch line exceeded {_MAX_WATCH_LINE} bytes"
                        )
                    try:
                        msg = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    result = msg.get("result") or {}
                    if result.get("events"):
                        self.refresh()
            except Exception as e:
                if not self._watch_stop.is_set():
                    record_log.info("etcd watch stream ended: %s", e)
            finally:
                self._watch_conn = None
                if conn is not None:
                    try:
                        conn.close()
                    except Exception:
                        pass
            self._watch_stop.wait(self.refresh_interval_s)

    def _headers(self):
        if self._user and self._auth_token is None:
            resp = request(
                f"{self.endpoint}/v3/auth/authenticate",
                method="POST",
                data=json.dumps(
                    {"name": self._user, "password": self._password}
                ).encode(),
            )
            if resp.status == 200:
                self._auth_token = resp.json().get("token")
        return {"Authorization": self._auth_token} if self._auth_token else {}

    def _range(self, keys_only: bool = False) -> dict:
        payload = {"key": _b64(self.rule_key)}
        if keys_only:
            # metadata-only poll: kvs come back with mod_revision but no
            # value, so the change check doesn't transfer the rule payload
            payload["keys_only"] = True
        for attempt in (0, 1):
            resp = request(
                f"{self.endpoint}/v3/kv/range",
                method="POST",
                data=json.dumps(payload).encode(),
                headers=self._headers(),
                timeout_s=5.0,
            )
            if resp.status == 200:
                return resp.json()
            # etcd simple tokens expire (default TTL 300s); drop the cached
            # token and re-authenticate once instead of failing every poll
            # until restart
            if resp.status in (401, 403) and self._user and attempt == 0:
                self._auth_token = None
                continue
            break
        raise RuntimeError(f"etcd range failed: {resp.status} {resp.text}")

    def read_source(self) -> str:
        body = self._range()
        kvs = body.get("kvs") or []
        if not kvs:
            self._last_mod_rev = 0
            return ""
        self._last_mod_rev = int(kvs[0].get("mod_revision", 0))
        return base64.b64decode(kvs[0].get("value", "")).decode("utf-8")

    def is_modified(self) -> bool:
        body = self._range(keys_only=True)
        kvs = body.get("kvs") or []
        rev = int(kvs[0].get("mod_revision", 0)) if kvs else 0
        return rev != (self._last_mod_rev or 0)
