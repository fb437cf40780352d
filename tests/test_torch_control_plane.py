"""The port's operator surface on the CPU: the command center
(``sentinel_tpu_torch.transport``), its ASGI twin, the metric log
(``metrics.log``), the heartbeat and the datasource-driven cluster
assignment (``cluster.assign``).

Reruns, case for case, the reference's ``tests/test_control_plane.py``
against the port's copies: ``TestCommandCenter``, ``TestAsgiCommandCenter``,
``TestMetricLog``, ``TestHeartbeat``, ``TestSwitchCommands`` and
``TestDatasourceClusterAssignment`` (``TestDatasources`` runs in
``test_torch_datasources.py``). Where the reference's ``setClusterMode``
builds ``DefaultTokenService()`` (on the card in the port), these pass the
port's one explicit way to ask for the CPU: a ``server_factory``.

Then what the port does where the reference falls back or swallows:

- ``csp.sentinel.cluster.server.native=true`` with a library that does not
  build raises out of ``apply_cluster_mode`` and registers no server (the
  reference quietly serves through the asyncio door);
- a mode property whose service fails to build raises out of the
  listener, and a polling data source counts it as a failed refresh; a
  payload the reference rejects (a bad mode value, an assignment without a
  server) is logged and changes nothing.
"""

import json
import logging
import os
import shutil
import socket
import threading
import urllib.error
import urllib.request

import pytest

pytest.importorskip("torch")

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="no C++ compiler for the native library (local windows, doors)",
)

import torch_parity  # noqa: E402,F401  (stat and metric logs to a temp dir)
import sentinel_tpu_torch.local as sentinel  # noqa: E402
from sentinel_tpu_torch.cluster import api as cluster_api  # noqa: E402
from sentinel_tpu_torch.cluster import assign  # noqa: E402
from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    DefaultTokenService,
)
from sentinel_tpu_torch.core import clock as t_clock  # noqa: E402
from sentinel_tpu_torch.core.config import SentinelConfig  # noqa: E402
from sentinel_tpu_torch.core.property import DynamicProperty  # noqa: E402
from sentinel_tpu_torch.datasource import (  # noqa: E402
    FileRefreshableDataSource,
    FileWritableDataSource,
    WritableDataSourceRegistry,
)
from sentinel_tpu_torch.datasource import base as ds_base  # noqa: E402
from sentinel_tpu_torch.engine import ClusterFlowRule, EngineConfig  # noqa: E402
from sentinel_tpu_torch.engine.rules import ThresholdMode  # noqa: E402
from sentinel_tpu_torch.local import BlockException  # noqa: E402
from sentinel_tpu_torch.metrics.log import (  # noqa: E402
    MetricNode,
    MetricSearcher,
    MetricTimer,
    MetricWriter,
)
from sentinel_tpu_torch.transport import handlers as H  # noqa: E402
from sentinel_tpu_torch.transport.command import CommandCenter  # noqa: E402

CFG = EngineConfig(max_flows=16, max_namespaces=4, batch_size=64)


def cpu_server(server_cls, host, port):
    """``setClusterMode`` mode 1 on the CPU: the reference's
    ``DefaultTokenService()`` with ``device="cpu"``."""
    return server_cls(DefaultTokenService(device="cpu"), host=host, port=port)


@pytest.fixture
def manual_clock():
    """The port's ``ManualClock`` (the suite's fixture installs the JAX
    package's)."""
    mc = t_clock.ManualClock()
    prev = t_clock.set_clock(mc)
    yield mc
    t_clock.set_clock(prev)


@pytest.fixture(autouse=True)
def clean_engine(manual_clock):
    sentinel.reset_for_tests()
    WritableDataSourceRegistry.reset_for_tests()
    # the properties a test sets go again after it (a reset of every
    # property would also drop torch_parity's log directory)
    props = dict(SentinelConfig._props)
    # the heartbeat payload names this address instead of probing a route
    SentinelConfig.set("csp.sentinel.heartbeat.client.ip", "127.0.0.1")
    yield manual_clock
    WritableDataSourceRegistry.reset_for_tests()
    sentinel.reset_for_tests()
    SentinelConfig._props.clear()
    SentinelConfig._props.update(props)


@pytest.fixture
def command_center():
    cc = CommandCenter(host="127.0.0.1", port=0,
                       server_factory=cpu_server).start()
    yield cc
    cc.stop()


def http_get(cc, path, timeout=5):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{cc.port}/{path}", timeout=timeout
    ) as r:
        return r.status, r.read().decode()


def http_post(cc, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{cc.port}/{path}", data=body.encode(), method="POST"
    )
    with urllib.request.urlopen(req, timeout=5) as r:
        return r.status, r.read().decode()


def free_port():
    sock = socket.socket()
    sock.bind(("0.0.0.0", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


class TestCommandCenter:
    def test_api_lists_commands(self, command_center):
        status, body = http_get(command_center, "api")
        urls = {item["url"] for item in json.loads(body)}
        for expected in ("version", "getRules", "setRules", "metric",
                         "clusterNode", "basicInfo", "systemStatus"):
            assert f"/{expected}" in urls

    def test_version_and_basic_info(self, command_center):
        status, body = http_get(command_center, "version")
        assert "sentinel-tpu/" in body
        status, body = http_get(command_center, "basicInfo")
        info = json.loads(body)
        assert info["pid"] > 0

    def test_rule_crud_roundtrip(self, command_center):
        status, body = http_post(
            command_center, "setRules?type=flow",
            json.dumps([{"resource": "cmd_res", "count": 1}]),
        )
        assert body == "success"
        ok = blocked = 0
        for _ in range(3):
            try:
                with sentinel.entry("cmd_res"):
                    ok += 1
            except BlockException:
                blocked += 1
        assert (ok, blocked) == (1, 2)
        status, body = http_get(command_center, "getRules?type=flow")
        rules = json.loads(body)
        assert rules[0]["resource"] == "cmd_res"

    def test_gateway_api_definitions_roundtrip(self, command_center):
        from sentinel_tpu_torch.adapters.gateway_api import (
            GatewayApiDefinitionManager,
            GatewayApiMatcherManager,
        )

        try:
            defs = [{"apiName": "prod-api", "predicateItems": [
                {"pattern": "/product/", "matchStrategy": 1}]}]
            status, body = http_post(
                command_center, "gateway/updateApiDefinitions",
                json.dumps(defs),
            )
            assert body == "success"
            status, body = http_get(
                command_center, "gateway/getApiDefinitions"
            )
            assert json.loads(body) == defs
            assert GatewayApiMatcherManager.pick_matching_api_names(
                "/product/7"
            ) == ["prod-api"]
        finally:
            GatewayApiDefinitionManager.reset_for_tests()

    def test_set_rules_writes_through_datasource(self, command_center,
                                                 tmp_path):
        from sentinel_tpu_torch.datasource import converters as conv

        path = tmp_path / "flow_out.json"
        WritableDataSourceRegistry.register(
            "flow", FileWritableDataSource(str(path), conv.flow_rules_to_json)
        )
        http_post(
            command_center, "setRules?type=flow",
            json.dumps([{"resource": "w_res", "count": 5}]),
        )
        saved = json.loads(path.read_text())
        assert saved[0]["resource"] == "w_res"
        assert saved[0]["count"] == 5

    def test_cluster_node_stats(self, command_center):
        with sentinel.entry("stat_cmd_res"):
            pass
        status, body = http_get(command_center, "clusterNode")
        names = [n["resourceName"] for n in json.loads(body)]
        assert "stat_cmd_res" in names

    def test_unknown_command_404(self, command_center):
        with pytest.raises(urllib.error.HTTPError) as info:
            http_get(command_center, "nonsense")
        assert info.value.code == 404
        assert "api" in info.value.read().decode()

    def test_cluster_mode_commands(self, command_center):
        status, body = http_get(command_center, "getClusterMode")
        assert json.loads(body)["mode"] == -1
        http_get(command_center, "setClusterMode?mode=0")
        status, body = http_get(command_center, "getClusterMode")
        assert json.loads(body)["mode"] == 0
        cluster_api.reset_for_tests()

    def test_demotion_clears_embedded_service(self, command_center):
        try:
            status, body = http_get(
                command_center, "setClusterMode?mode=1&tokenPort=0",
                timeout=120,
            )
            assert "success" in body
            service = cluster_api.get_embedded_server()
            assert isinstance(service, DefaultTokenService)
            assert service.device.type == "cpu"  # the command center's ask
            status, body = http_get(command_center, "cluster/server/info")
            assert status == 200 and "error" not in body
            http_get(command_center, "setClusterMode?mode=-1")
            assert cluster_api.get_embedded_server() is None
            status, body = http_get(command_center, "cluster/server/info")
            assert "error" in body
        finally:
            H.apply_cluster_mode(-1)
            cluster_api.reset_for_tests()


def asgi_call(app, path, method="GET", query="", body=b""):
    import asyncio

    sent = []

    async def run():
        scope = {"type": "http", "method": method, "path": path,
                 "query_string": query.encode()}
        chunks = [{"type": "http.request", "body": body}]

        async def receive():
            return chunks.pop(0)

        async def send(msg):
            sent.append(msg)

        await app(scope, receive, send)

    asyncio.run(run())
    status = next(
        m["status"] for m in sent if m["type"] == "http.response.start"
    )
    out = b"".join(
        m.get("body", b"") for m in sent if m["type"] == "http.response.body"
    )
    return status, out


class TestAsgiCommandCenter:
    """The same handler registry, served by the app's own ASGI server."""

    def test_api_version_and_unknown(self):
        from sentinel_tpu_torch.transport.command_asgi import command_asgi_app

        app = command_asgi_app()
        status, body = asgi_call(app, "/api")
        assert status == 200 and b"getRules" in body
        status, body = asgi_call(app, "/version")
        assert status == 200 and b"sentinel-tpu" in body
        status, _ = asgi_call(app, "/definitely-not-a-command")
        assert status == 404

    def test_rule_crud_matches_thread_server(self):
        from sentinel_tpu_torch.transport.command_asgi import command_asgi_app

        app = command_asgi_app()
        rules = [{"resource": "asgi_res", "count": 7, "grade": 1}]
        status, body = asgi_call(
            app, "/setRules", method="POST", query="type=flow",
            body=json.dumps(rules).encode(),
        )
        assert status == 200 and b"success" in body
        status, body = asgi_call(app, "/getRules", query="type=flow")
        assert status == 200
        assert any(r["resource"] == "asgi_res" for r in json.loads(body))

    def test_body_size_cap(self):
        from sentinel_tpu_torch.transport.command_asgi import command_asgi_app

        app = command_asgi_app(max_body_bytes=64)
        status, _ = asgi_call(
            app, "/setRules", method="POST", query="type=flow",
            body=b"x" * 128,
        )
        assert status == 413

    def test_lifespan_protocol(self):
        import asyncio

        from sentinel_tpu_torch.transport.command_asgi import command_asgi_app

        app = command_asgi_app()
        sent = []

        async def run():
            msgs = [{"type": "lifespan.startup"},
                    {"type": "lifespan.shutdown"}]

            async def receive():
                return msgs.pop(0)

            async def send(msg):
                sent.append(msg["type"])

            await app({"type": "lifespan"}, receive, send)

        asyncio.run(run())
        assert sent == ["lifespan.startup.complete",
                        "lifespan.shutdown.complete"]


class TestMetricLog:
    def test_writer_searcher_roundtrip(self, tmp_path):
        w = MetricWriter(base_dir=str(tmp_path), single_file_size=10_000)
        nodes = [
            MetricNode(timestamp_ms=1_700_000_000_000, resource="res|pipe",
                       pass_qps=10, block_qps=2, rt=1.5),
            MetricNode(timestamp_ms=1_700_000_000_000, resource="other",
                       pass_qps=3),
        ]
        w.write(nodes)
        w.close()
        s = MetricSearcher(str(tmp_path), w.app)
        found = s.find(1_699_999_999_000, 1_700_000_001_000)
        assert len(found) == 2
        assert found[0].resource == "res_pipe"  # pipe escaped
        assert found[0].pass_qps == 10
        only = s.find(0, 2**61, identity="other")
        assert len(only) == 1 and only[0].pass_qps == 3

    def test_searcher_seeks_via_index(self, tmp_path):
        w = MetricWriter(base_dir=str(tmp_path), single_file_size=10_000_000)
        t0 = 1_700_000_000_000
        for i in range(200):
            w.write([MetricNode(timestamp_ms=t0 + i * 1000, resource="r",
                                pass_qps=i)])
        w.close()
        s = MetricSearcher(str(tmp_path), w.app)
        found = s.find(t0 + 150_000, t0 + 152_000)
        assert [n.pass_qps for n in found] == [150, 151, 152]
        idx = str(tmp_path / f"{w.app}-metrics.log.0.idx")
        assert s._seek_offset(idx, t0 + 150_000) > 0

    def test_rolling_keeps_bounded_files(self, tmp_path):
        w = MetricWriter(base_dir=str(tmp_path), single_file_size=200,
                         total_file_count=3)
        for i in range(40):
            w.write([MetricNode(timestamp_ms=1_700_000_000_000 + i * 1000,
                                resource=f"r{i}", pass_qps=1)])
        w.close()
        files = [f for f in os.listdir(tmp_path) if not f.endswith(".idx")]
        assert 1 <= len(files) <= 3

    def test_metric_timer_collects_from_engine(self, manual_clock):
        with sentinel.entry("timer_res"):
            pass
        manual_clock.sleep(1000)  # into the next second: the last is whole
        timer = MetricTimer.__new__(MetricTimer)  # no writer needed
        names = [n.resource for n in MetricTimer.collect_once(timer)]
        assert "timer_res" in names


class TestHeartbeat:
    def test_heartbeat_posts_registration(self, command_center):
        received = {}
        from sentinel_tpu_torch.transport.command import command_mapping
        from sentinel_tpu_torch.transport.heartbeat import HeartbeatSender

        @command_mapping("registry/machine", "test stub")
        def stub(params, body):
            received.update(json.loads(body))
            return "ok"

        hb = HeartbeatSender(
            dashboard_addrs=[f"127.0.0.1:{command_center.port}"],
            command_port=1234,
        )
        assert hb.send_once() is True
        assert received["port"] == 1234
        assert received["app"]
        assert received["version"].startswith("sentinel-tpu/")


class TestSwitchCommands:
    """``sentinel_tpu_torch.local.sph`` resolves to the module, not the
    re-exported ``sph`` function."""

    def test_get_and_set_switch_roundtrip(self, command_center):
        status, body = http_get(command_center, "getSwitch")
        assert status == 200
        assert json.loads(body)["enabled"] is True
        status, body = http_get(command_center, "setSwitch?value=false")
        assert status == 200 and "success" in body
        status, body = http_get(command_center, "getSwitch")
        assert json.loads(body)["enabled"] is False
        http_get(command_center, "setSwitch?value=true")
        status, body = http_get(command_center, "getSwitch")
        assert json.loads(body)["enabled"] is True

    def test_set_switch_rejects_bad_value(self, command_center):
        status, body = http_get(command_center, "setSwitch?value=banana")
        assert "error" in body

    def test_local_reset_for_tests_direct(self):
        import sentinel_tpu_torch.local as local_pkg

        local_pkg.reset_for_tests()  # must not raise
        from sentinel_tpu_torch.local.sph import is_enabled

        assert is_enabled() is True


class TestDatasourceClusterAssignment:
    """Property/datasource-driven cluster reconfiguration
    (ClusterClientConfigManager / ClusterStateManager property path)."""

    @pytest.fixture(autouse=True)
    def clean(self):
        yield
        assign.reset_for_tests()
        H.apply_cluster_mode(-1)  # stop any promoted server
        H._CLUSTER_CLIENT_CONFIG.clear()
        cluster_api.reset_for_tests()

    def test_file_assignment_repoints_client(self, tmp_path):
        from sentinel_tpu_torch.cluster.server import TokenServer

        svc = DefaultTokenService(CFG, device="cpu")
        svc.load_rules(
            [ClusterFlowRule(flow_id=1, count=3.0,
                             mode=ThresholdMode.GLOBAL)]
        )
        server = TokenServer(svc, port=0)
        server.start()
        try:
            path = tmp_path / "assign.json"
            path.write_text(json.dumps(
                {"serverHost": "127.0.0.1", "serverPort": server.port,
                 "requestTimeout": 2000, "namespace": "nsX"}
            ))
            ds = FileRefreshableDataSource(str(path), converter=json.loads)
            assign.register_client_assign_property(ds.property)
            ds.refresh()
            assert H._CLUSTER_CLIENT_CONFIG["serverPort"] == server.port
            assert H._CLUSTER_CLIENT_CONFIG["namespace"] == "nsX"
            assert cluster_api.get_mode() == cluster_api.ClusterMode.CLIENT
            oks = sum(
                cluster_api._pick_service().request_token(1).ok
                for _ in range(5)
            )
            assert oks == 3
            path.write_text(json.dumps(
                {"serverHost": "127.0.0.1", "serverPort": server.port,
                 "requestTimeout": 50, "namespace": "nsY"}
            ))
            ds.refresh()
            assert H._CLUSTER_CLIENT_CONFIG["namespace"] == "nsY"
        finally:
            server.stop()

    def test_mode_property_promotes_and_demotes(self):
        prop = DynamicProperty()
        assign.register_cluster_mode_property(prop, cpu_server)
        prop.update_value({"mode": 1, "tokenPort": 0})
        assert cluster_api.get_embedded_server() is not None
        assert cluster_api.get_mode() == cluster_api.ClusterMode.SERVER
        prop.update_value(-1)
        assert cluster_api.get_embedded_server() is None

    def test_identical_assignment_does_not_churn_connection(self):
        prop = DynamicProperty()
        assign.register_client_assign_property(prop)
        payload = {"serverHost": "127.0.0.1", "serverPort": 19999}
        prop.update_value(dict(payload))
        first = cluster_api._client
        assert first is not None
        prop.update_value({**payload, "_noise": 1})  # dict differs, config same
        assert cluster_api._client is first

    def test_mode_property_port_change_moves_server(self):
        prop = DynamicProperty()
        assign.register_cluster_mode_property(prop, cpu_server)
        prop.update_value({"mode": 1, "tokenPort": 0})
        first = H._EMBEDDED_SERVER["server"]
        port2 = free_port()
        prop.update_value({"mode": 1, "tokenPort": port2})
        second = H._EMBEDDED_SERVER["server"]
        assert second.port == port2
        assert second.service is first.service  # rules/counters preserved

    def test_reassignment_after_demotion_restores_client_mode(self):
        payload = {"serverHost": "127.0.0.1", "serverPort": 19998}
        assert H.apply_client_assignment(payload) is None
        assert cluster_api.get_mode() == cluster_api.ClusterMode.CLIENT
        H.apply_cluster_mode(-1)
        assert cluster_api.get_mode() == cluster_api.ClusterMode.NOT_STARTED
        assert H.apply_client_assignment(payload) is None
        assert cluster_api.get_mode() == cluster_api.ClusterMode.CLIENT
        assert cluster_api._pick_service() is not None

    def test_mode_port_move_rolls_back_on_bind_failure(self):
        H.apply_cluster_mode(1, 0, cpu_server)
        server = H._EMBEDDED_SERVER["server"]
        old_port = server.port
        service = server.service
        service.load_rules(
            [ClusterFlowRule(flow_id=9, count=5.0, mode=ThresholdMode.GLOBAL)]
        )
        blocker = socket.socket()
        blocker.bind(("0.0.0.0", 0))
        blocker.listen(1)
        busy_port = blocker.getsockname()[1]
        try:
            with pytest.raises(Exception):
                H.apply_cluster_mode(1, busy_port)
            rolled = H._EMBEDDED_SERVER["server"]
            assert rolled is not None
            assert rolled.port == old_port
            assert rolled.service is service
            assert [r.flow_id for r in rolled.service.current_rules()] == [9]
        finally:
            blocker.close()

    def test_native_transport_selected_by_config(self):
        from sentinel_tpu_torch.cluster.server_native import NativeTokenServer

        SentinelConfig.set("csp.sentinel.cluster.server.native", "true")
        try:
            H.apply_cluster_mode(1, 0, cpu_server)
            server = H._EMBEDDED_SERVER["server"]
            assert isinstance(server, NativeTokenServer)
            new_port = free_port()
            H.apply_cluster_mode(1, new_port)
            moved = H._EMBEDDED_SERVER["server"]
            assert isinstance(moved, NativeTokenServer)
            assert moved.port == new_port
        finally:
            H.apply_cluster_mode(-1)

    def test_port_move_preserves_server_tuning(self):
        H.apply_cluster_mode(1, 0, cpu_server)
        server = H._EMBEDDED_SERVER["server"]
        server.batch_window_ms = 0.7
        server.max_batch = 512
        server.inline_below = 16
        server.idle_ttl_s = 123.0
        new_port = free_port()
        H.apply_cluster_mode(1, new_port)
        moved = H._EMBEDDED_SERVER["server"]
        assert moved is not server and moved.port == new_port
        assert moved.batch_window_ms == 0.7
        assert moved.max_batch == 512
        assert moved.inline_below == 16
        assert moved.idle_ttl_s == 123.0

    def test_port_move_rearms_concurrent_expiry(self):
        from sentinel_tpu_torch.cluster.concurrent import ConcurrentFlowRule

        H.apply_cluster_mode(1, 0, cpu_server)
        service = H._EMBEDDED_SERVER["server"].service
        service.load_concurrent_rules(
            [ConcurrentFlowRule(flow_id=4, concurrency_level=2)]
        )
        assert service._expiry is not None
        new_port = free_port()
        H.apply_cluster_mode(1, new_port)
        moved = H._EMBEDDED_SERVER["server"]
        assert moved.port == new_port
        assert moved.service is service
        assert service._expiry is not None


class TestNoFallback:
    """Where the reference falls back or swallows, the port raises."""

    @pytest.fixture(autouse=True)
    def clean(self):
        yield
        assign.reset_for_tests()
        H.apply_cluster_mode(-1)
        cluster_api.reset_for_tests()
        ds_base.reset_refresh_failures_for_tests()

    def test_native_config_without_the_library_raises(self, monkeypatch):
        from sentinel_tpu_torch.native import lib as native_lib

        def unbuilt():
            raise RuntimeError("native build failed (test)")

        monkeypatch.setattr(native_lib, "load", unbuilt)
        SentinelConfig.set("csp.sentinel.cluster.server.native", "true")
        with pytest.raises(RuntimeError, match="native build failed"):
            H.apply_cluster_mode(1, 0, cpu_server)
        assert H._EMBEDDED_SERVER["server"] is None
        assert cluster_api.get_embedded_server() is None

    def test_setclustermode_without_a_factory_asks_for_the_card(
            self, monkeypatch):
        # no server_factory: the reference's DefaultTokenService(), whose
        # default device is the card; without one it raises, never serves
        # from the CPU
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            H.apply_cluster_mode(1, 0)
        assert H._EMBEDDED_SERVER["server"] is None

    def test_failed_promotion_raises_out_of_the_mode_listener(self):
        def broken(server_cls, host, port):
            raise RuntimeError("the card service failed to build (test)")

        prop = DynamicProperty()
        assign.register_cluster_mode_property(prop, broken)
        with pytest.raises(RuntimeError, match="failed to build"):
            prop.update_value({"mode": 1, "tokenPort": 0})
        assert cluster_api.get_embedded_server() is None

    def test_failed_promotion_counts_as_a_failed_refresh(self, tmp_path):
        def broken(server_cls, host, port):
            raise RuntimeError("the card service failed to build (test)")

        direct = tmp_path / "direct.json"
        direct.write_text(json.dumps({"mode": 1, "tokenPort": 0}))
        ds = FileRefreshableDataSource(str(direct), converter=json.loads)
        assign.register_cluster_mode_property(ds.property, broken)
        with pytest.raises(RuntimeError, match="failed to build"):
            ds.refresh()  # a direct refresh raises the listener's error
        polled = tmp_path / "mode.json"
        polled.write_text(json.dumps({"mode": -1}))
        ds = FileRefreshableDataSource(str(polled), converter=json.loads,
                                       refresh_interval_s=0.05)
        assign.register_cluster_mode_property(ds.property, broken)
        ds.start()
        try:
            polled.write_text(json.dumps({"mode": 1, "tokenPort": 0}))
            wait = threading.Event()
            for _ in range(200):
                if ds_base.refresh_failure_totals():
                    break
                wait.wait(0.05)
        finally:
            ds.close()
        assert sum(ds_base.refresh_failure_totals().values()) == 1
        assert cluster_api.get_embedded_server() is None

    def test_rejected_payloads_are_logged_and_change_nothing(self):
        from sentinel_tpu_torch.core.log import record_log

        calls, logged = [], []

        def factory(server_cls, host, port):
            calls.append(port)
            return cpu_server(server_cls, host, port)

        prop = DynamicProperty()
        assign.register_cluster_mode_property(prop, factory)
        assign.register_client_assign_property(prop_a := DynamicProperty())
        handler = logging.Handler(logging.WARNING)
        handler.emit = lambda record: logged.append(record.getMessage())
        record_log.addHandler(handler)
        try:
            prop.update_value({"mode": 7})  # no such mode
            prop.update_value("banana")
            prop_a.update_value(["not", "a", "mapping"])
            prop_a.update_value({"serverPort": 18730})  # no host
        finally:
            record_log.removeHandler(handler)
        assert calls == []
        assert cluster_api.get_mode() == cluster_api.ClusterMode.NOT_STARTED
        assert cluster_api._client is None
        assert len(logged) == 4 and all("rejected" in m for m in logged)
