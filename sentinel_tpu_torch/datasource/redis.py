"""Redis datasource (analog of ``sentinel-datasource-redis``).

Reference model: initial rules from ``GET ruleKey``; updates arrive as
pub/sub messages on ``channel`` whose *payload is the new rule JSON* (the
publisher sends the full config, the datasource never re-reads the key on a
message). Same protocol here over a ~100-line RESP2 client — no vendored
client library.
"""

from __future__ import annotations

import socket
import threading
from typing import List, Optional

from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.datasource.base import Converter, ReadableDataSource

_CRLF = b"\r\n"


class RespError(RuntimeError):
    pass


def encode_command(*parts: str) -> bytes:
    """RESP array of bulk strings — the only request shape clients send."""
    out = [b"*%d" % len(parts), _CRLF]
    for p in parts:
        raw = p.encode() if isinstance(p, str) else p
        out += [b"$%d" % len(raw), _CRLF, raw, _CRLF]
    return b"".join(out)


class _Reader:
    """Buffered RESP2 reply parser over a socket."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = b""

    def _line(self) -> bytes:
        while _CRLF not in self.buf:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self.buf += chunk
        line, self.buf = self.buf.split(_CRLF, 1)
        return line

    def _exact(self, n: int) -> bytes:
        while len(self.buf) < n + 2:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self.buf += chunk
        data, self.buf = self.buf[:n], self.buf[n + 2:]  # strip CRLF
        return data

    def read_reply(self):
        line = self._line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RespError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            return None if n == -1 else self._exact(n)
        if kind == b"*":
            n = int(rest)
            return None if n == -1 else [self.read_reply() for _ in range(n)]
        raise RespError(f"unexpected RESP type byte {kind!r}")


class RedisClient:
    """Minimal synchronous RESP2 client (GET/AUTH/SELECT/SUBSCRIBE)."""

    def __init__(self, host="127.0.0.1", port=6379, password: Optional[str] = None,
                 db: int = 0, timeout_s: float = 5.0):
        self.sock = socket.create_connection((host, port), timeout=timeout_s)
        self.reader = _Reader(self.sock)
        if password:
            self.execute("AUTH", password)
        if db:
            self.execute("SELECT", str(db))

    def execute(self, *parts: str):
        self.sock.sendall(encode_command(*parts))
        return self.reader.read_reply()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class RedisDataSource(ReadableDataSource):
    def __init__(
        self,
        converter: Converter,
        host: str = "127.0.0.1",
        port: int = 6379,
        rule_key: str = "sentinel.rules",
        channel: str = "sentinel.rules.channel",
        password: Optional[str] = None,
        db: int = 0,
    ):
        super().__init__(converter)
        self._conn_args = (host, port, password, db)
        self.rule_key = rule_key
        self.channel = channel
        self._sub: Optional[RedisClient] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def read_source(self) -> str:
        host, port, password, db = self._conn_args
        client = RedisClient(host, port, password, db)
        try:
            raw = client.execute("GET", self.rule_key)
            return raw.decode() if isinstance(raw, bytes) else (raw or "")
        finally:
            client.close()

    _RECONNECT_DELAY_S = 1.0

    def start(self) -> "RedisDataSource":
        self.refresh()  # initial GET
        self._subscribe()  # fail fast if redis is down at startup
        self._thread = threading.Thread(
            target=self._listen, daemon=True, name="sentinel-redis-sub"
        )
        self._thread.start()
        return self

    def _subscribe(self) -> None:
        host, port, password, db = self._conn_args
        self._sub = RedisClient(host, port, password, db)
        self._sub.execute("SUBSCRIBE", self.channel)
        self._sub.sock.settimeout(None)  # block on messages indefinitely

    def _listen(self) -> None:
        while not self._stop.is_set():
            try:
                reply = self._sub.reader.read_reply()
            except (ConnectionError, OSError, RespError):
                if self._stop.is_set():
                    return
                # redis restarted / transient drop: resubscribe with backoff
                # and re-read the key — a publish during the gap is lost on
                # the pub/sub channel, so the GET resync is load-bearing
                record_log.warning(
                    "redis subscription lost; reconnecting in %ss",
                    self._RECONNECT_DELAY_S,
                )
                self._sub.close()
                if self._stop.wait(self._RECONNECT_DELAY_S):
                    return
                try:
                    self._subscribe()
                    self.refresh()
                except (ConnectionError, OSError, RespError) as e:
                    # RespError covers transient server states like
                    # "-LOADING ..." right after a restart — retry, don't die
                    record_log.warning("redis reconnect failed: %s", e)
                continue
            if not (isinstance(reply, list) and len(reply) == 3):
                continue
            kind, _chan, payload = reply
            if kind == b"message" and isinstance(payload, bytes):
                # the published payload IS the new config
                try:
                    self.property.update_value(
                        self.converter(payload.decode())
                    )
                except Exception as e:
                    record_log.warning("redis rule payload rejected: %s", e)

    def close(self) -> None:
        self._stop.set()
        if self._sub is not None:
            self._sub.close()
        if self._thread is not None:
            self._thread.join(timeout=2)


def parse_subscribe_messages(replies: List) -> List[bytes]:
    """Test helper: extract message payloads from raw pub/sub replies."""
    return [
        r[2] for r in replies
        if isinstance(r, list) and len(r) == 3 and r[0] == b"message"
    ]
