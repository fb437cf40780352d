"""The port's data sources (``sentinel_tpu_torch.datasource``) on the CPU.

Reruns, case for case, against the port's copies:

- the reference's ``tests/test_datasources.py``: every backend against an
  in-process fake speaking its wire protocol (HTTP for consul, etcd, nacos,
  apollo, eureka and the config server; RESP over a socket for redis; an
  injected fake client for zookeeper);
- ``tests/test_control_plane.py::TestDatasources``: the file source loads
  and follows changes, keeps the last good rules, and the JSON schema
  round-trips;
- ``tests/test_replication.py::TestDatasourceBackoff``: a failed parse
  keeps the last good config, the poll interval backs off and caps.

``TestDatasourceClusterAssignment`` of ``test_control_plane.py`` needs the
cluster assignment module, which the port does not have yet.
"""

import base64
import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

pytest.importorskip("torch")

import torch_parity  # noqa: E402,F401  (stat logs to a temp dir)
import sentinel_tpu_torch.local as sentinel  # noqa: E402
from sentinel_tpu_torch.core import clock as t_clock  # noqa: E402
from sentinel_tpu_torch.datasource import (  # noqa: E402
    ApolloDataSource,
    ConsulDataSource,
    EtcdDataSource,
    EurekaDataSource,
    FileRefreshableDataSource,
    NacosDataSource,
    RedisDataSource,
    SpringCloudConfigDataSource,
    WritableDataSourceRegistry,
    ZookeeperDataSource,
    flow_rules_from_json,
    flow_rules_to_json,
)
from sentinel_tpu_torch.local import FlowRuleManager  # noqa: E402


@pytest.fixture
def manual_clock():
    """The port's ``ManualClock`` (the suite's fixture installs the JAX
    package's)."""
    mc = t_clock.ManualClock()
    prev = t_clock.set_clock(mc)
    yield mc
    t_clock.set_clock(prev)


RULES_V1 = json.dumps([{"resource": "r", "count": 5}])
RULES_V2 = json.dumps([{"resource": "r", "count": 9}])


def wait_for(pred, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


class FakeHttp:
    """Configurable fake HTTP server; route -> callable(handler) or
    (status, headers, body) tuple."""

    def __init__(self):
        fake = self

        class Handler(BaseHTTPRequestHandler):
            def _serve(self):
                path = self.path.split("?")[0]
                route = fake.routes.get((self.command, path))
                if route is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                if callable(route):
                    route(self)
                    return
                status, headers, body = route
                self.send_response(status)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            do_GET = do_POST = _serve

            def log_message(self, *a):  # quiet
                pass

        self.routes = {}
        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(
            target=self.server.serve_forever, daemon=True
        )
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture
def http_server():
    srv = FakeHttp()
    yield srv
    srv.close()


def counts(ds):
    rules = ds.property.value or []
    return [r.count for r in rules]


class TestConsul:
    def test_initial_read_and_push(self, http_server):
        state = {"value": RULES_V1, "index": 7}
        changed = threading.Event()

        def kv(h):
            qs = h.path.split("?", 1)[1] if "?" in h.path else ""
            if "index=" in qs:  # blocking query: wait for a change signal
                changed.wait(2)
            h.send_response(200)
            h.send_header("X-Consul-Index", str(state["index"]))
            h.end_headers()
            payload = [{"Value": base64.b64encode(
                state["value"].encode()).decode()}]
            h.wfile.write(json.dumps(payload).encode())

        http_server.routes[("GET", "/v1/kv/sentinel/rules")] = kv
        ds = ConsulDataSource(
            flow_rules_from_json, port=http_server.port, wait_s=1
        ).start()
        try:
            assert counts(ds) == [5]
            state.update(value=RULES_V2, index=8)
            changed.set()
            assert wait_for(lambda: counts(ds) == [9])
        finally:
            ds.close()


class TestEtcd:
    def test_watch_stream_triggers_refresh(self, http_server):
        # true watch (jetcd Watch analog): the /v3/watch chunked stream
        # delivers an events message and the value updates WITHOUT waiting
        # for a mod-revision poll (poll interval here is far beyond the
        # wait_for window)
        state = {"value": RULES_V1, "rev": 1}
        changed = threading.Event()

        def rng(h):
            length = int(h.headers.get("Content-Length", 0))
            h.rfile.read(length)
            h.send_response(200)
            h.end_headers()
            body = {"kvs": [{
                "value": base64.b64encode(state["value"].encode()).decode(),
                "mod_revision": str(state["rev"]),
            }]}
            h.wfile.write(json.dumps(body).encode())

        def watch(h):
            length = int(h.headers.get("Content-Length", 0))
            req = json.loads(h.rfile.read(length))
            assert "create_request" in req
            # real chunked transfer needs HTTP/1.1 on the status line —
            # under the handler's default HTTP/1.0 the client ignores
            # Transfer-Encoding and this test wouldn't exercise dechunking
            h.protocol_version = "HTTP/1.1"
            h.send_response(200)
            h.send_header("Transfer-Encoding", "chunked")
            h.end_headers()

            def chunk(obj):
                data = json.dumps(obj).encode() + b"\n"
                h.wfile.write(f"{len(data):x}\r\n".encode())
                h.wfile.write(data + b"\r\n")
                h.wfile.flush()

            chunk({"result": {"created": True}})
            if changed.wait(5):
                chunk({"result": {"events": [{"type": "PUT"}]}})
            # hold the stream open briefly so the client reads the event,
            # then end the chunked body properly
            changed.wait(0.2)
            h.wfile.write(b"0\r\n\r\n")
            h.close_connection = True

        http_server.routes[("POST", "/v3/kv/range")] = rng
        http_server.routes[("POST", "/v3/watch")] = watch
        ds = EtcdDataSource(
            flow_rules_from_json,
            endpoint=f"http://127.0.0.1:{http_server.port}",
            refresh_interval_s=30.0,  # poll can't be what picks this up
        ).start()
        try:
            assert counts(ds) == [5]
            state.update(value=RULES_V2, rev=2)
            changed.set()
            assert wait_for(lambda: counts(ds) == [9])
        finally:
            ds.close()

    def test_poll_on_mod_revision(self, http_server):
        state = {"value": RULES_V1, "rev": 1}

        def rng(h):
            length = int(h.headers.get("Content-Length", 0))
            h.rfile.read(length)
            h.send_response(200)
            h.end_headers()
            body = {"kvs": [{
                "value": base64.b64encode(state["value"].encode()).decode(),
                "mod_revision": str(state["rev"]),
            }]}
            h.wfile.write(json.dumps(body).encode())

        http_server.routes[("POST", "/v3/kv/range")] = rng
        ds = EtcdDataSource(
            flow_rules_from_json,
            endpoint=f"http://127.0.0.1:{http_server.port}",
            refresh_interval_s=0.05,
            watch=False,  # this test exercises the poll backstop alone
        ).start()
        try:
            assert counts(ds) == [5]
            state.update(value=RULES_V2, rev=2)
            assert wait_for(lambda: counts(ds) == [9])
        finally:
            ds.close()


class TestNacos:
    def test_long_poll_change(self, http_server):
        state = {"value": RULES_V1}
        changed = threading.Event()

        def get_cfg(h):
            h.send_response(200)
            h.end_headers()
            h.wfile.write(state["value"].encode())

        def listener(h):
            length = int(h.headers.get("Content-Length", 0))
            h.rfile.read(length)
            fired = changed.wait(1)
            h.send_response(200)
            h.end_headers()
            if fired:
                changed.clear()
                h.wfile.write(b"sentinel-rules%02DEFAULT_GROUP%01")

        http_server.routes[("GET", "/nacos/v1/cs/configs")] = get_cfg
        http_server.routes[("POST", "/nacos/v1/cs/configs/listener")] = listener
        ds = NacosDataSource(
            flow_rules_from_json,
            server_addr=f"127.0.0.1:{http_server.port}",
            data_id="sentinel-rules",
            long_poll_timeout_ms=1000,
        ).start()
        try:
            assert counts(ds) == [5]
            state["value"] = RULES_V2
            changed.set()
            assert wait_for(lambda: counts(ds) == [9])
        finally:
            ds.close()


class TestApollo:
    def test_notification_long_poll(self, http_server):
        state = {"value": RULES_V1, "nid": 3}
        changed = threading.Event()

        def configs(h):
            h.send_response(200)
            h.end_headers()
            h.wfile.write(json.dumps({
                "configurations": {"sentinel.rules": state["value"]}
            }).encode())

        def notifications(h):
            fired = changed.wait(1)
            if not fired:
                h.send_response(304)
                h.end_headers()
                return
            changed.clear()
            h.send_response(200)
            h.end_headers()
            h.wfile.write(json.dumps([{
                "namespaceName": "application",
                "notificationId": state["nid"],
            }]).encode())

        http_server.routes[
            ("GET", "/configs/sentinel/default/application")] = configs
        http_server.routes[("GET", "/notifications/v2")] = notifications
        ds = ApolloDataSource(
            flow_rules_from_json,
            server_url=f"http://127.0.0.1:{http_server.port}",
            long_poll_timeout_s=1,
        ).start()
        try:
            assert counts(ds) == [5]
            state.update(value=RULES_V2, nid=4)
            changed.set()
            assert wait_for(lambda: counts(ds) == [9])
            assert ds._notification_id == 4
        finally:
            ds.close()


class TestEureka:
    def test_reads_instance_metadata_with_fallback(self, http_server):
        body = json.dumps({"application": {"instance": [
            {"instanceId": "other", "metadata": {}},
            {"instanceId": "i-1",
             "metadata": {"sentinel.rules": RULES_V1}},
        ]}}).encode()
        http_server.routes[("GET", "/eureka/apps/svc")] = (
            200, {"Content-Type": "application/json"}, body)
        ds = EurekaDataSource(
            flow_rules_from_json,
            app_id="svc",
            instance_id="i-1",
            service_urls=(
                "http://127.0.0.1:1/eureka",  # dead replica → fallback
                f"http://127.0.0.1:{http_server.port}/eureka",
            ),
            refresh_interval_s=60,
        ).start()
        try:
            assert counts(ds) == [5]
        finally:
            ds.close()


class TestSpringCloudConfig:
    def test_property_source_precedence(self, http_server):
        body = json.dumps({"propertySources": [
            {"source": {"sentinel.rules": RULES_V2}},  # wins (front = highest)
            {"source": {"sentinel.rules": RULES_V1}},
        ]}).encode()
        http_server.routes[("GET", "/sentinel/default/main")] = (
            200, {}, body)
        ds = SpringCloudConfigDataSource(
            flow_rules_from_json,
            uri=f"http://127.0.0.1:{http_server.port}",
            label="main",
            refresh_interval_s=60,
        ).start()
        try:
            assert counts(ds) == [9]
        finally:
            ds.close()


class FakeRedis:
    """Minimal RESP2 server: GET of one key + SUBSCRIBE with later publishes."""

    def __init__(self, rule_key, value):
        self.rule_key = rule_key
        self.value = value
        self.subscribers = []
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self.sock.listen()
        self._stop = False
        threading.Thread(target=self._accept, daemon=True).start()

    @staticmethod
    def _bulk(b):
        return b"$%d\r\n%s\r\n" % (len(b), b)

    def _accept(self):
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            ).start()

    def _serve(self, conn):
        f = conn.makefile("rb")
        while True:
            head = f.readline()
            if not head or not head.startswith(b"*"):
                return
            n = int(head[1:])
            parts = []
            for _ in range(n):
                f.readline()  # $len
                parts.append(f.readline().strip())
            cmd = parts[0].upper()
            if cmd == b"GET":
                conn.sendall(self._bulk(self.value.encode()))
            elif cmd == b"SUBSCRIBE":
                chan = parts[1]
                conn.sendall(b"*3\r\n" + self._bulk(b"subscribe")
                             + self._bulk(chan) + b":1\r\n")
                self.subscribers.append((conn, chan))
            else:
                conn.sendall(b"+OK\r\n")

    def publish(self, payload: str):
        for conn, chan in self.subscribers:
            conn.sendall(b"*3\r\n" + self._bulk(b"message")
                         + self._bulk(chan) + self._bulk(payload.encode()))

    def close(self):
        self._stop = True
        self.sock.close()


class TestRedis:
    def test_reconnects_after_subscription_drop(self):
        srv = FakeRedis("sentinel.rules", RULES_V1)
        ds = RedisDataSource(
            flow_rules_from_json, port=srv.port,
            rule_key="sentinel.rules", channel="chan",
        )
        ds._RECONNECT_DELAY_S = 0.05
        ds.start()
        try:
            assert wait_for(lambda: srv.subscribers)
            # kill the subscription socket server-side; the value changes
            # while the channel is down — the resync GET must pick it up
            conn, _ = srv.subscribers.pop()
            srv.value = RULES_V2
            # shutdown (not just close): the server's makefile still holds
            # the fd, so close() alone would never send the FIN
            conn.shutdown(socket.SHUT_RDWR)
            conn.close()
            assert wait_for(lambda: srv.subscribers)  # resubscribed
            assert wait_for(lambda: counts(ds) == [9])
            srv.publish(json.dumps([{"resource": "r", "count": 3}]))
            assert wait_for(lambda: counts(ds) == [3])
        finally:
            ds.close()
            srv.close()

    def test_get_then_pubsub_update(self):
        srv = FakeRedis("sentinel.rules", RULES_V1)
        ds = RedisDataSource(
            flow_rules_from_json, port=srv.port,
            rule_key="sentinel.rules", channel="chan",
        ).start()
        try:
            assert counts(ds) == [5]
            assert wait_for(lambda: srv.subscribers)
            srv.publish(RULES_V2)
            assert wait_for(lambda: counts(ds) == [9])
        finally:
            ds.close()
            srv.close()


class FakeZkClient:
    def __init__(self, data):
        self.data = data
        self.watchers = []
        self.started = False

    def start(self):
        self.started = True

    def stop(self):
        self.started = False

    def ensure_path(self, path):
        pass

    def get(self, path):
        return self.data, object()

    def DataWatch(self, path, func):  # noqa: N802 (kazoo's API name)
        self.watchers.append(func)
        func(self.data, object())

    def set(self, data):
        self.data = data
        for func in self.watchers:
            func(data, object())


class TestZookeeper:
    def test_watch_fires_initial_and_updates(self):
        client = FakeZkClient(RULES_V1.encode())
        ds = ZookeeperDataSource(
            flow_rules_from_json, client=client
        ).start()
        assert counts(ds) == [5]
        client.set(RULES_V2.encode())
        assert counts(ds) == [9]
        assert ds.read_source() == RULES_V2
        ds.close()


# -- the reference's test_control_plane.py::TestDatasources -----------------
RULES_JSON = json.dumps(
    [{"resource": "ds_res", "count": 2, "grade": 1, "limitApp": "default"}]
)


@pytest.fixture
def clean_engine(manual_clock):
    sentinel.reset_for_tests()
    WritableDataSourceRegistry.reset_for_tests()
    yield manual_clock
    WritableDataSourceRegistry.reset_for_tests()
    sentinel.reset_for_tests()


@pytest.mark.usefixtures("clean_engine")
class TestDatasources:
    def test_file_datasource_loads_and_follows_changes(self, tmp_path, manual_clock):
        path = tmp_path / "flow.json"
        path.write_text(RULES_JSON)
        ds = FileRefreshableDataSource(str(path), flow_rules_from_json,
                                       refresh_interval_s=0.05)
        FlowRuleManager.register_property(ds.property)
        ds.start()
        try:
            assert len(FlowRuleManager.get_rules("ds_res")) == 1
            assert FlowRuleManager.get_rules("ds_res")[0].count == 2
            # change the file → rules follow
            path.write_text(json.dumps([{"resource": "ds_res", "count": 9}]))
            deadline = threading.Event()
            for _ in range(100):
                if FlowRuleManager.get_rules("ds_res") and \
                        FlowRuleManager.get_rules("ds_res")[0].count == 9:
                    break
                deadline.wait(0.05)
            assert FlowRuleManager.get_rules("ds_res")[0].count == 9
        finally:
            ds.close()

    def test_sentinel_json_schema_roundtrip(self):
        rules = flow_rules_from_json(RULES_JSON)
        text = flow_rules_to_json(rules)
        again = flow_rules_from_json(text)
        assert again == rules

    def test_malformed_file_keeps_last_good_rules(self, tmp_path, manual_clock):
        path = tmp_path / "flow.json"
        path.write_text(RULES_JSON)
        ds = FileRefreshableDataSource(str(path), flow_rules_from_json)
        FlowRuleManager.register_property(ds.property)
        ds.refresh()
        assert len(FlowRuleManager.get_rules("ds_res")) == 1
        path.write_text("{not json")
        ds.refresh()  # swallowed, logged
        assert len(FlowRuleManager.get_rules("ds_res")) == 1


# -- the reference's test_replication.py::TestDatasourceBackoff -------------
class TestDatasourceBackoff:
    def test_failed_parse_retains_last_known_good(self):
        from sentinel_tpu_torch.datasource.base import (
            ReadableDataSource,
            refresh_failure_totals,
            reset_refresh_failures_for_tests,
        )

        reset_refresh_failures_for_tests()

        class Src(ReadableDataSource):
            def __init__(self):
                super().__init__(converter=lambda s: json.loads(s))
                self.raw = '["rule-a"]'

            def read_source(self):
                return self.raw

        src = Src()
        assert src.refresh() is True
        assert src.property.value == ["rule-a"]
        src.raw = '{"truncated'  # torn mid-write
        assert src.refresh() is False
        assert src.property.value == ["rule-a"], "stale beats none"
        src.raw = "null"  # parses, but to nothing
        assert src.refresh() is False
        assert src.property.value == ["rule-a"]
        assert refresh_failure_totals().get("Src", 0) == 2

    def test_poll_interval_backs_off_and_caps(self):
        from sentinel_tpu_torch.datasource.base import AutoRefreshDataSource

        src = AutoRefreshDataSource(converter=lambda s: s,
                                    refresh_interval_s=1.0)
        assert src._poll_interval_s() == 1.0
        src._consecutive_failures = 2
        assert src._poll_interval_s() == 4.0
        src._consecutive_failures = 30
        assert src._poll_interval_s() == 10.0  # capped at 10×
        src._consecutive_failures = 0
        assert src._poll_interval_s() == 1.0

    def test_loop_counts_consecutive_failures(self):
        from sentinel_tpu_torch.datasource.base import AutoRefreshDataSource

        boom = AutoRefreshDataSource(
            converter=lambda s: s, refresh_interval_s=0.01
        )
        boom.read_source = lambda: (_ for _ in ()).throw(IOError("down"))
        boom.start()
        try:
            deadline = time.monotonic() + 2.0
            while (boom._consecutive_failures < 2
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            assert boom._consecutive_failures >= 2
        finally:
            boom.close()
