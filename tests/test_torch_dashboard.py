"""The port's dashboard (``sentinel_tpu_torch.dashboard``): the
reference's ``tests/test_dashboard.py`` (39 cases) rerun against the port,
on the port's own ``ManualClock``. The app command centers get a CPU
``server_factory``, so ``cluster/assign`` promotes a CPU token service; the
port's own cases follow: a promotion that fails on the machine shows in the
dashboard's answer. The cross-package session is in
``tests/test_torch_dashboard_parity.py``."""

import json
import shutil
import urllib.request

import pytest

pytest.importorskip("torch")

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="no C++ compiler for the native library (local windows)",
)

import torch_parity  # noqa: E402,F401  (stat logs to a temp dir)
import sentinel_tpu_torch.local as sentinel  # noqa: E402
from sentinel_tpu_torch.core import clock as t_clock  # noqa: E402
from sentinel_tpu_torch.dashboard import (  # noqa: E402
    AppManagement,
    DashboardServer,
    InMemoryMetricsRepository,
    MachineInfo,
    MetricEntry,
    MetricFetcher,
)


@pytest.fixture
def manual_clock():
    """The port's deterministic clock for the duration of a test (the
    conftest's fixture installs the JAX package's)."""
    mc = t_clock.ManualClock()
    prev = t_clock.set_clock(mc)
    yield mc
    t_clock.set_clock(prev)


def cpu_server(server_cls, host, port):
    """The ``server_factory`` of the tests' command centers: mode 1 serves a
    CPU token service."""
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService

    return server_cls(DefaultTokenService(device="cpu"), host=host,
                      port=port)


@pytest.fixture(autouse=True)
def clean():
    sentinel.reset_for_tests()
    yield
    sentinel.reset_for_tests()


class TestDiscovery:
    def test_register_and_health(self, manual_clock):
        apps = AppManagement()
        apps.register(MachineInfo(app="svc", ip="10.0.0.1", port=8719))
        assert apps.apps() == ["svc"]
        assert len(apps.healthy_machines("svc")) == 1
        manual_clock.sleep(40_000)  # heartbeat stale
        assert apps.healthy_machines("svc") == []
        assert len(apps.machines("svc")) == 1  # still listed, marked dead
        assert apps.machines("svc")[0].to_dict()["healthy"] is False

    def test_reregister_updates_heartbeat(self, manual_clock):
        apps = AppManagement()
        apps.register(MachineInfo(app="svc", ip="10.0.0.1", port=8719))
        manual_clock.sleep(40_000)
        apps.register(MachineInfo(app="svc", ip="10.0.0.1", port=8719))
        assert len(apps.healthy_machines("svc")) == 1
        assert len(apps.machines("svc")) == 1  # same key, no duplicate

    def test_invalid_machine_rejected(self):
        apps = AppManagement()
        with pytest.raises(ValueError):
            apps.register(MachineInfo(app="", ip="1.2.3.4", port=1))


class TestRepository:
    def test_save_query_and_retention(self, manual_clock):
        repo = InMemoryMetricsRepository()
        t0 = manual_clock.now_ms()
        repo.save(MetricEntry("svc", "res", t0, pass_qps=10))
        manual_clock.sleep(6 * 60 * 1000)  # beyond 5-min retention
        repo.save(MetricEntry("svc", "res", manual_clock.now_ms(), pass_qps=20))
        entries = repo.query("svc", "res", 0, 2**61)
        assert [e.pass_qps for e in entries] == [20]  # old entry evicted

    def test_resources_sorted_by_volume(self, manual_clock):
        repo = InMemoryMetricsRepository()
        now = manual_clock.now_ms()
        repo.save(MetricEntry("svc", "cold", now, pass_qps=1))
        repo.save(MetricEntry("svc", "hot", now, pass_qps=100))
        repo.save(MetricEntry("other_app", "x", now, pass_qps=999))
        assert repo.resources_of_app("svc") == ["hot", "cold"]


class TestFetcher:
    def test_aggregates_across_machines(self, manual_clock, monkeypatch):
        from sentinel_tpu_torch.metrics.log import MetricNode

        apps = AppManagement()
        repo = InMemoryMetricsRepository()
        fetcher = MetricFetcher(apps, repo)
        apps.register(MachineInfo(app="svc", ip="10.0.0.1", port=1))
        apps.register(MachineInfo(app="svc", ip="10.0.0.2", port=1))
        ts = manual_clock.now_ms() // 1000 * 1000 - 3000

        def fake_fetch(machine, start, end):
            return [MetricNode(timestamp_ms=ts, resource="res", pass_qps=5,
                               block_qps=1, rt=2.0)]

        monkeypatch.setattr(fetcher.client, "fetch_metrics", fake_fetch)
        stored = fetcher.fetch_once("svc")
        assert stored == 2  # one line per machine, merged in the repository
        entry = repo.query("svc", "res", 0, 2**61)[0]
        assert entry.pass_qps == 10  # summed across the two machines
        assert entry.block_qps == 2

    def test_failed_machine_retries_same_window(self, manual_clock, monkeypatch):
        """A machine whose fetch fails must not have its window advanced —
        the data is re-requested next tick (per-machine last-fetch)."""
        from sentinel_tpu_torch.metrics.log import MetricNode

        apps = AppManagement()
        repo = InMemoryMetricsRepository()
        fetcher = MetricFetcher(apps, repo)
        apps.register(MachineInfo(app="svc", ip="10.0.0.1", port=1))
        apps.register(MachineInfo(app="svc", ip="10.0.0.2", port=1))
        ts = manual_clock.now_ms() // 1000 * 1000 - 3000
        fail_m2 = True

        def fake_fetch(machine, start, end):
            if machine.ip == "10.0.0.2" and fail_m2:
                return None  # transport failure
            if start <= ts <= end:
                return [MetricNode(timestamp_ms=ts, resource="res", pass_qps=5)]
            return []

        monkeypatch.setattr(fetcher.client, "fetch_metrics", fake_fetch)
        fetcher.fetch_once("svc")
        assert repo.query("svc", "res", 0, 2**61)[0].pass_qps == 5
        manual_clock.sleep(500)
        fail_m2 = False
        fetcher.fetch_once("svc")  # m2 catches up over its original window
        assert repo.query("svc", "res", 0, 2**61)[0].pass_qps == 10

    def test_dead_app_cursors_pruned(self, manual_clock, monkeypatch):
        from sentinel_tpu_torch.metrics.log import MetricNode

        apps = AppManagement()
        repo = InMemoryMetricsRepository()
        fetcher = MetricFetcher(apps, repo)
        apps.register(MachineInfo(app="svc", ip="10.0.0.1", port=1))
        ts = manual_clock.now_ms() // 1000 * 1000 - 3000
        monkeypatch.setattr(
            fetcher.client, "fetch_metrics",
            lambda machine, start, end: [
                MetricNode(timestamp_ms=ts, resource="res", pass_qps=1)
            ],
        )
        fetcher.fetch_once("svc")
        assert any(k[0] == "svc" for k in fetcher._last_fetch)
        # the app disappears from discovery entirely: the loop-side prune
        # must drop its cursors (fetch_once never visits it again)
        fetcher.prune_dead_apps([])
        assert not fetcher._last_fetch

    def test_idle_series_evicted(self, manual_clock):
        """Series that stop receiving traffic age out of the store (and the
        sidebar) instead of leaking forever."""
        from sentinel_tpu_torch.dashboard.repository import MetricEntry

        repo = InMemoryMetricsRepository(retention_ms=10_000)
        manual_clock.set_ms(1_000)
        repo.save(MetricEntry("svc", "dead-url", 1_000, pass_qps=5))
        manual_clock.set_ms(30_000)
        assert repo.query("svc", "dead-url", 0, 2**61) == []  # past retention
        repo.save(MetricEntry("svc", "live", 30_000, pass_qps=1))
        assert ("svc", "dead-url") not in repo._store  # swept on save
        assert repo.resources_of_app("svc") == ["live"]

    def test_window_advances(self, manual_clock, monkeypatch):
        apps = AppManagement()
        repo = InMemoryMetricsRepository()
        fetcher = MetricFetcher(apps, repo)
        apps.register(MachineInfo(app="svc", ip="10.0.0.1", port=1))
        windows = []

        def fake_fetch(machine, start, end):
            windows.append((start, end))
            return []

        monkeypatch.setattr(fetcher.client, "fetch_metrics", fake_fetch)
        fetcher.fetch_once("svc")
        manual_clock.sleep(1000)
        fetcher.fetch_once("svc")
        # contiguous with no overlap: search windows are inclusive both ends,
        # so the next must start 1ms after the last ended (a second-aligned
        # line at the boundary would otherwise merge-sum twice)
        assert windows[1][0] == windows[0][1] + 1


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/{path}", timeout=5) as r:
        return json.loads(r.read().decode())


def _post(port: int, path: str, payload, cookie=None, timeout=5):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{path}",
        data=json.dumps(payload).encode(),
        headers={"Cookie": cookie} if cookie else {},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}"), e.headers


class TestAuth:
    def test_login_gates_api(self):
        import urllib.error

        dash = DashboardServer(port=0, auth=("admin", "s3cret")).start()
        try:
            # unauthenticated API access → 401; console shell stays open
            try:
                _get(dash.port, "apps")
                assert False, "expected 401"
            except urllib.error.HTTPError as e:
                assert e.code == 401
            with urllib.request.urlopen(
                f"http://127.0.0.1:{dash.port}/", timeout=5
            ) as r:
                assert b"login" in r.read()
            # bad credentials rejected
            code, _, _ = _post(dash.port, "auth/login",
                               {"username": "admin", "password": "nope"})
            assert code == 401
            # good credentials → session cookie → API opens up
            code, _, headers = _post(dash.port, "auth/login",
                                     {"username": "admin", "password": "s3cret"})
            assert code == 200
            cookie = headers["Set-Cookie"].split(";")[0]
            req = urllib.request.Request(
                f"http://127.0.0.1:{dash.port}/apps",
                headers={"Cookie": cookie},
            )
            with urllib.request.urlopen(req, timeout=5) as r:
                assert r.status == 200
            # heartbeat endpoint stays open for apps
            code, body, _ = _post(dash.port, "registry/machine",
                                  {"app": "a", "ip": "1.2.3.4", "port": 1})
            assert code == 200 and body["code"] == 0
        finally:
            dash.stop()


class TestClusterAssign:
    def test_assign_flips_modes_and_points_clients(self, manual_clock):
        from sentinel_tpu_torch.transport.command import CommandCenter
        from sentinel_tpu_torch.transport import handlers as _h  # register commands
        from sentinel_tpu_torch.cluster import api as cluster_api

        cluster_api.reset_for_tests()
        dash = DashboardServer(port=0).start()
        cc = CommandCenter(port=0, server_factory=cpu_server)
        cc.start()
        try:
            _post(dash.port, "registry/machine",
                  {"app": "svc", "ip": "127.0.0.1", "port": cc.port})
            state = _get(dash.port, "cluster/state?app=svc")
            assert state[0]["mode"] == -1  # off
            # promote compiles the decision kernels on the agent (multi-
            # second); the ApiClient grants setClusterMode PROMOTE_TIMEOUT_S
            # (120s), so the outer call must wait at least as long
            code, result, _ = _post(
                dash.port, "cluster/assign?app=svc",
                {"server": f"127.0.0.1:{cc.port}", "tokenPort": 28731},
                timeout=150,
            )
            assert code == 200 and result["server"] is True
            state = _get(dash.port, "cluster/state?app=svc")
            assert state[0]["mode"] == 1  # the one machine became the server
            # the monitor screen sees the promoted server's info
            mon = _get(dash.port, "cluster/monitor?app=svc")
            assert len(mon["servers"]) == 1 and mon["clients"] == []
            info = mon["servers"][0]["info"]
            assert info["embedded"] is True and info["port"] == 28731
            assert "maxAllowedQps" in info["flow"]
            # mode 1 actually provisioned a listening token server
            from sentinel_tpu_torch.cluster.client import TokenClient
            from sentinel_tpu_torch.engine.decide import TokenStatus

            tc = TokenClient("127.0.0.1", 28731, timeout_ms=2000)
            res = tc.request_token(12345)  # no rule loaded
            assert res.status == TokenStatus.NO_RULE_EXISTS
            tc.close()
            # switching away stops it (plain-text "success" response)
            _get(dash.port, "apps")  # keep dash alive
            with urllib.request.urlopen(
                f"http://127.0.0.1:{cc.port}/setClusterMode?mode=-1", timeout=5
            ) as r:
                assert b"success" in r.read()
            assert cluster_api.get_mode() == cluster_api.ClusterMode.NOT_STARTED
        finally:
            from sentinel_tpu_torch.transport.handlers import _EMBEDDED_SERVER

            srv = _EMBEDDED_SERVER.pop("server", None)
            _EMBEDDED_SERVER["server"] = None
            if srv is not None:
                srv.stop()
            cc.stop()
            dash.stop()
            cluster_api.reset_for_tests()

    def test_assign_aborts_when_server_unreachable(self, manual_clock):
        dash = DashboardServer(port=0).start()
        try:
            # register a machine whose command port is dead
            _post(dash.port, "registry/machine",
                  {"app": "svc", "ip": "127.0.0.1", "port": 1})
            code, result, _ = _post(
                dash.port, "cluster/assign?app=svc",
                {"server": "127.0.0.1:1"},
            )
            assert code == 200 and "error" in result
        finally:
            dash.stop()


class TestMachineRemoval:
    def test_remove_single_machine_then_app(self):
        dash = DashboardServer(port=0).start()
        try:
            _post(dash.port, "registry/machine",
                  {"app": "svc", "ip": "10.0.0.1", "port": 1})
            _post(dash.port, "registry/machine",
                  {"app": "svc", "ip": "10.0.0.2", "port": 1})
            code, body, _ = _post(
                dash.port, "machine/remove?app=svc&ip=10.0.0.1&port=1", {})
            assert body["code"] == 0
            apps = _get(dash.port, "apps")
            assert len(apps[0]["machines"]) == 1
            # removing the last machine drops the app
            _post(dash.port, "machine/remove?app=svc&ip=10.0.0.2&port=1", {})
            assert _get(dash.port, "apps") == []
        finally:
            dash.stop()


class TestGatewayRuleRoundTrip:
    def test_get_set_via_command_center(self):
        from sentinel_tpu_torch.transport.command import CommandCenter
        from sentinel_tpu_torch.transport import handlers as _h  # register commands
        from sentinel_tpu_torch.adapters.gateway import GatewayRuleManager

        cc = CommandCenter(port=0)
        cc.start()
        try:
            rules = [{
                "resource": "route-a", "resourceMode": 0, "count": 5.0,
                "grade": 1, "intervalSec": 1, "controlBehavior": 0,
                "burst": 2, "maxQueueingTimeoutMs": 500,
                "paramItem": {"parseStrategy": 0, "fieldName": None,
                              "pattern": None, "matchStrategy": 0},
            }]
            req = urllib.request.Request(
                f"http://127.0.0.1:{cc.port}/setRules?type=gateway",
                data=json.dumps(rules).encode(),
            )
            with urllib.request.urlopen(req, timeout=5) as r:
                assert r.status == 200
            assert GatewayRuleManager.rules_for("route-a")
            got = _get(cc.port, "getRules?type=gateway")
            assert got[0]["resource"] == "route-a"
            assert got[0]["burst"] == 2
        finally:
            GatewayRuleManager.load_rules([])
            cc.stop()


class TestEndToEnd:
    def test_full_pull_pipeline(self):
        """app (command center + metric log + heartbeat) → dashboard."""
        import time

        from sentinel_tpu_torch.local import FlowRule, FlowRuleManager
        from sentinel_tpu_torch.metrics.log import MetricTimer, MetricWriter
        from sentinel_tpu_torch.transport.command import CommandCenter
        from sentinel_tpu_torch.transport.heartbeat import HeartbeatSender

        import tempfile

        dash = DashboardServer(port=0, fetch_interval_s=0.2).start()
        cc = CommandCenter(port=0)
        cc.start()
        with tempfile.TemporaryDirectory() as tmp:
            # point the app's metric log (writer and /metric command) at tmp
            import sentinel_tpu_torch.metrics.log as mlog

            orig = mlog.default_metric_dir
            mlog.default_metric_dir = lambda: tmp
            timer = MetricTimer(MetricWriter(base_dir=tmp), interval_s=0.2)
            try:
                FlowRuleManager.load_rules([FlowRule(resource="e2e_res", count=1000)])
                hb = HeartbeatSender(
                    dashboard_addrs=[f"127.0.0.1:{dash.port}"],
                    command_port=cc.port, interval_ms=200,
                    client_ip="127.0.0.1",
                )
                assert hb.send_once()
                timer.start()
                # generate traffic across ~2 aggregation seconds
                deadline = time.time() + 2.5
                while time.time() < deadline:
                    with sentinel.entry("e2e_res"):
                        pass
                    time.sleep(0.01)
                # dashboard registered the machine
                apps = _get(dash.port, "apps")
                names = [a["name"] for a in apps]
                assert any(a["machines"] for a in apps)
                # fetcher pulled metrics for the guarded resource
                found = []
                for _ in range(30):
                    app_name = names[0]
                    res = _get(dash.port, f"resources?app={app_name}")
                    if "e2e_res" in res:
                        found = _get(
                            dash.port,
                            f"metric?app={app_name}&identity=e2e_res"
                            f"&startTime=0&endTime={2**61}",
                        )
                        if found:
                            break
                    time.sleep(0.2)
                assert found, "dashboard never received e2e_res metrics"
                assert sum(e["passQps"] for e in found) > 0
            finally:
                mlog.default_metric_dir = orig
                timer.stop()
                cc.stop()
                dash.stop()

    def test_rule_push_proxied_to_app(self):
        from sentinel_tpu_torch.local import FlowRuleManager
        from sentinel_tpu_torch.transport.command import CommandCenter

        dash = DashboardServer(port=0).start()
        cc = CommandCenter(port=0)
        cc.start()
        try:
            # register the app machine by hand (no heartbeat thread needed)
            dash.apps.register(
                MachineInfo(app="svc", ip="127.0.0.1", port=cc.port)
            )
            body = json.dumps([{"resource": "pushed_res", "count": 7}]).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{dash.port}/rules?app=svc&type=flow",
                data=body, headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=5) as r:
                out = json.loads(r.read().decode())
            assert out["pushed"] == 1
            rules = FlowRuleManager.all_rules()
            assert any(r.resource == "pushed_res" and r.count == 7 for r in rules)
            # and fetch back through the dashboard proxy
            fetched = _get(dash.port, "rules?app=svc&type=flow")
            assert any(r["resource"] == "pushed_res" for r in fetched)
        finally:
            cc.stop()
            dash.stop()

    def test_gateway_api_groups_proxied(self):
        from sentinel_tpu_torch.adapters.gateway_api import (
            GatewayApiDefinitionManager,
        )
        from sentinel_tpu_torch.transport.command import CommandCenter

        dash = DashboardServer(port=0).start()
        cc = CommandCenter(port=0)
        cc.start()
        try:
            dash.apps.register(
                MachineInfo(app="svc", ip="127.0.0.1", port=cc.port)
            )
            defs = [{"apiName": "orders-api", "predicateItems": [
                {"pattern": "/orders", "matchStrategy": 0}]}]
            code, out, _ = _post(dash.port, "v1/gateway/apis?app=svc", defs)
            assert code == 200 and out["pushed"] == 1
            fetched = _get(dash.port, "v1/gateway/apis?app=svc")
            assert fetched == defs
        finally:
            GatewayApiDefinitionManager.reset_for_tests()
            cc.stop()
            dash.stop()

    def test_console_page_served(self):
        dash = DashboardServer(port=0).start()
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{dash.port}/", timeout=5
            ) as r:
                html = r.read().decode()
            assert "sentinel-tpu console" in html
        finally:
            dash.stop()


def _req(port, path, method="GET", payload=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{path}", data=data, method=method,
    )
    with urllib.request.urlopen(req, timeout=5) as r:
        return json.loads(r.read().decode())


class TestRuleCrudViews:
    """Per-rule-type create→edit→delete round-trips through the v1 CRUD
    endpoints against a LIVE agent (FlowControllerV1 & siblings over
    InMemoryRuleRepositoryAdapter, through the SentinelApiClient analog).
    Verification reads the rules BACK from the agent via the fetch proxy, so
    the whole push→agent→fetch loop is exercised."""

    # rule_type → (create payload, update payload, key(dict))
    CASES = {
        "flow": (
            {"resource": "crud_res", "count": 5, "grade": 1},
            {"resource": "crud_res", "count": 9, "grade": 1},
            lambda d: (d.get("resource"), d.get("count")),
        ),
        "degrade": (
            {"resource": "crud_deg", "grade": 0, "count": 100, "timeWindow": 10},
            {"resource": "crud_deg", "grade": 0, "count": 250, "timeWindow": 10},
            lambda d: (d.get("resource"), d.get("count")),
        ),
        "system": (
            {"qps": 1000},
            {"qps": 2000},
            lambda d: ("system", d.get("qps")),
        ),
        "authority": (
            {"resource": "crud_auth", "limitApp": "appA", "strategy": 0},
            {"resource": "crud_auth", "limitApp": "appB", "strategy": 0},
            lambda d: (d.get("resource"), d.get("limitApp")),
        ),
        "paramFlow": (
            {"resource": "crud_param", "paramIdx": 0, "count": 50},
            {"resource": "crud_param", "paramIdx": 0, "count": 75},
            lambda d: (d.get("resource"), d.get("count")),
        ),
        "gateway": (
            {"resource": "crud_gw", "count": 30, "resourceMode": 0},
            {"resource": "crud_gw", "count": 60, "resourceMode": 0},
            lambda d: (d.get("resource"), d.get("count")),
        ),
    }
    EXPECT = {
        "flow": (("crud_res", 5.0), ("crud_res", 9.0)),
        "degrade": (("crud_deg", 100.0), ("crud_deg", 250.0)),
        "system": (("system", 1000.0), ("system", 2000.0)),
        "authority": (("crud_auth", "appA"), ("crud_auth", "appB")),
        "paramFlow": (("crud_param", 50.0), ("crud_param", 75.0)),
        "gateway": (("crud_gw", 30.0), ("crud_gw", 60.0)),
    }

    @pytest.mark.parametrize("rule_type", list(CASES))
    def test_create_edit_delete_roundtrip(self, rule_type):
        from sentinel_tpu_torch.adapters.gateway import GatewayRuleManager
        from sentinel_tpu_torch.transport.command import CommandCenter

        create, update, key_of = self.CASES[rule_type]
        expect_created, expect_updated = self.EXPECT[rule_type]
        dash = DashboardServer(port=0).start()
        cc = CommandCenter(port=0)
        cc.start()
        try:
            dash.apps.register(
                MachineInfo(app="svc", ip="127.0.0.1", port=cc.port)
            )
            qs = f"app=svc&type={rule_type}"

            def live_keys():
                fetched = _req(dash.port, f"rules?{qs}")  # live agent fetch
                return [key_of(d) for d in fetched]

            # CREATE: pushed to the live agent
            out = _req(dash.port, f"v1/rule?{qs}", "POST", create)
            assert out.get("pushed") == 1, out
            assert expect_created in live_keys()
            # LIST: the console view sees the rule with an id
            listed = _req(dash.port, f"v1/rules?{qs}")
            assert listed and all("id" in e for e in listed)
            rule_id = listed[-1]["id"]
            # EDIT
            out = _req(dash.port, f"v1/rule?{qs}&id={rule_id}", "PUT", update)
            assert out.get("pushed") == 1, out
            assert expect_updated in live_keys()
            assert expect_created not in live_keys()
            # DELETE
            out = _req(dash.port, f"v1/rule?{qs}&id={rule_id}", "DELETE")
            assert out.get("pushed") == 1, out
            assert expect_updated not in live_keys()
        finally:
            cc.stop()
            dash.stop()
            GatewayRuleManager.reset_for_tests()

    def test_sync_keeps_ids_stable_across_fetches(self):
        # re-syncing the same live rule set must keep each rule's id (the
        # reference's InMemoryRuleRepositoryAdapter holds ids server-side):
        # unstable ids let one console tab orphan another's in-flight edit
        from sentinel_tpu_torch.dashboard.rules_repo import InMemoryRuleRepository

        repo = InMemoryRuleRepository()
        rules = [
            {"resource": "a", "count": 5},
            {"resource": "b", "count": 9},
            {"resource": "a", "count": 5},  # duplicate content
        ]
        first = repo.sync("app", "flow", rules)
        again = repo.sync("app", "flow", list(rules))
        assert [e["id"] for e in first] == [e["id"] for e in again]
        # a changed rule gets a fresh id; untouched ones keep theirs
        rules[1] = {"resource": "b", "count": 42}
        third = repo.sync("app", "flow", rules)
        a_ids = lambda entries: sorted(  # noqa: E731
            e["id"] for e in entries if e["resource"] == "a"
        )
        assert a_ids(first) == a_ids(third)
        b_ids = [e["id"] for e in third if e["resource"] == "b"]
        assert b_ids and b_ids[0] not in [e["id"] for e in first]

    def test_update_unknown_id_errors(self):
        from sentinel_tpu_torch.transport.command import CommandCenter

        dash = DashboardServer(port=0).start()
        cc = CommandCenter(port=0).start()
        try:
            dash.apps.register(
                MachineInfo(app="svc", ip="127.0.0.1", port=cc.port)
            )
            out = _req(dash.port, "v1/rule?app=svc&type=flow&id=424242",
                       "PUT", {"resource": "x", "count": 1})
            assert "error" in out
        finally:
            cc.stop()
            dash.stop()

    def test_console_page_has_rule_views_and_chart(self):
        dash = DashboardServer(port=0).start()
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{dash.port}/", timeout=5
            ) as r:
                html = r.read().decode()
            for marker in ("SCHEMAS", "paramFlow", "gateway", "openChart",
                           "--series-1", "polyline", "rtchart",
                           "openCluster", "cluster/monitor",
                           "exception qps", "loadApiGroups",
                           "v1/gateway/apis"):
                assert marker in html, marker
        finally:
            dash.stop()

    def test_mutation_on_fresh_dashboard_preserves_agent_rules(self):
        # a restarted dashboard (empty repo) must not overwrite the rules an
        # agent already holds when a single-rule mutation arrives
        from sentinel_tpu_torch.local import FlowRule, FlowRuleManager
        from sentinel_tpu_torch.transport.command import CommandCenter

        dash = DashboardServer(port=0).start()
        cc = CommandCenter(port=0).start()
        try:
            dash.apps.register(
                MachineInfo(app="svc", ip="127.0.0.1", port=cc.port)
            )
            FlowRuleManager.load_rules(
                [FlowRule(resource="pre_existing", count=11)]
            )
            out = _req(dash.port, "v1/rule?app=svc&type=flow", "POST",
                       {"resource": "added_later", "count": 3})
            assert out.get("pushed") == 1
            resources = {r.resource for r in FlowRuleManager.all_rules()}
            assert resources == {"pre_existing", "added_later"}
        finally:
            cc.stop()
            dash.stop()


class TestPerMachineDrilldown:
    """Per-machine metric series (the reference metric.js drill-down)."""

    def test_machine_series_kept_alongside_merged(self, manual_clock):
        repo = InMemoryMetricsRepository()
        now = manual_clock.now_ms()
        repo.save(MetricEntry("svc", "res", now, pass_qps=5,
                              machine="10.0.0.1:1"), merge=True)
        repo.save(MetricEntry("svc", "res", now, pass_qps=7,
                              machine="10.0.0.2:1"), merge=True)
        merged = repo.query("svc", "res", 0, 2**61)
        assert [e.pass_qps for e in merged] == [12]
        assert merged[0].machine == ""  # the sum carries no machine tag
        m1 = repo.query_machine("svc", "10.0.0.1:1", "res", 0, 2**61)
        m2 = repo.query_machine("svc", "10.0.0.2:1", "res", 0, 2**61)
        assert [e.pass_qps for e in m1] == [5]
        assert [e.pass_qps for e in m2] == [7]
        assert repo.machines_of_resource("svc", "res") == [
            "10.0.0.1:1", "10.0.0.2:1"
        ]

    def test_machine_series_respects_retention(self, manual_clock):
        repo = InMemoryMetricsRepository()
        t0 = manual_clock.now_ms()
        repo.save(MetricEntry("svc", "res", t0, pass_qps=1,
                              machine="m:1"), merge=True)
        manual_clock.sleep(6 * 60 * 1000)
        repo.save(MetricEntry("svc", "res", manual_clock.now_ms(),
                              pass_qps=2, machine="m:1"), merge=True)
        assert [e.pass_qps for e in
                repo.query_machine("svc", "m:1", "res", 0, 2**61)] == [2]

    def test_fetcher_tags_machine_and_route_serves_it(
        self, manual_clock, monkeypatch
    ):
        from sentinel_tpu_torch.metrics.log import MetricNode

        dash = DashboardServer(port=0).start()
        try:
            apps = dash.apps
            apps.register(MachineInfo(app="svc", ip="10.0.0.1", port=1))
            apps.register(MachineInfo(app="svc", ip="10.0.0.2", port=1))
            ts = manual_clock.now_ms() // 1000 * 1000 - 3000

            def fake_fetch(machine, start, end):
                qps = 5 if machine.ip == "10.0.0.1" else 7
                return [MetricNode(timestamp_ms=ts, resource="res",
                                   pass_qps=qps)]

            monkeypatch.setattr(dash.fetcher.client, "fetch_metrics",
                                fake_fetch)
            dash.fetcher.fetch_once("svc")
            per_m = _get(
                dash.port,
                "metric?app=svc&identity=res&machine=10.0.0.1:1"
                "&startTime=0&endTime=2305843009213693952",
            )
            assert [e["passQps"] for e in per_m] == [5]
            machines = _get(dash.port, "metric/machines?app=svc&identity=res")
            assert machines == ["10.0.0.1:1", "10.0.0.2:1"]
            # identity.js analog: one machine's own resource list
            res = _get(dash.port, "resources?app=svc&machine=10.0.0.1:1")
            assert res == ["res"]
            assert _get(dash.port, "resources?app=svc&machine=10.9.9.9:1") == []
        finally:
            dash.stop()


class _FakeAssignClient:
    """Simulates per-machine agent state for assignment-management tests
    (two real agents can't coexist in one process — the embedded token
    server is process-global)."""

    def __init__(self, keys):
        self.mode = {k: -1 for k in keys}
        self.server_port = {}
        self.client_cfg = {}
        self.dead = set()

    def get_cluster_mode(self, m):
        return None if m.key in self.dead else self.mode[m.key]

    def set_cluster_mode(self, m, mode, token_port=None):
        if m.key in self.dead:
            return False
        self.mode[m.key] = mode
        if mode == 1:
            self.server_port[m.key] = token_port or 18730
        return True

    def push_cluster_client_config(self, m, host, port):
        if m.key in self.dead:
            return False
        self.client_cfg[m.key] = {"serverHost": host, "serverPort": port}
        return True

    def fetch_json(self, m, command, params=None):
        if m.key in self.dead:
            return None
        if command == "cluster/server/info":
            return {"port": self.server_port.get(m.key, 0)}
        if command == "cluster/client/fetchConfig":
            return dict(self.client_cfg.get(m.key, {}))
        return {}


class TestAssignManagement:
    """cluster/assign/state + cluster/assign/manage
    (cluster_app_assign_manage.js / ClusterAssignService analog)."""

    def _dash(self, n=4):
        dash = DashboardServer(port=0).start()
        keys = []
        for i in range(n):
            ip = f"10.0.0.{i + 1}"
            _post(dash.port, "registry/machine",
                  {"app": "svc", "ip": ip, "port": 1})
            keys.append(f"{ip}:1")
        fake = _FakeAssignClient(keys)
        dash.client = fake
        return dash, fake, keys

    def test_two_group_assign_then_unassign_cycle(self, manual_clock):
        dash, fake, keys = self._dash(4)
        try:
            code, res, _ = _post(
                dash.port, "cluster/assign/manage?app=svc",
                {"groups": [
                    {"server": keys[0], "tokenPort": 28001,
                     "clients": [keys[1]]},
                    {"server": keys[2], "tokenPort": 28002,
                     "clients": [keys[3]]},
                ]},
            )
            assert code == 200 and res["failed"] == []
            assert [g["clients"] for g in res["groups"]] == [1, 1]
            assert fake.mode == {keys[0]: 1, keys[1]: 0,
                                 keys[2]: 1, keys[3]: 0}
            state = _get(dash.port, "cluster/assign/state?app=svc")
            groups = {g["machine"]: g for g in state["servers"]}
            assert groups[keys[0]]["clients"] == [keys[1]]
            assert groups[keys[0]]["port"] == 28001
            assert groups[keys[2]]["clients"] == [keys[3]]
            assert state["unassigned"] == [] and state["unknown"] == []
            # unassign group 2: both machines back to standalone
            code, res, _ = _post(
                dash.port, "cluster/assign/manage?app=svc",
                {"unassign": [keys[2], keys[3]]},
            )
            assert code == 200 and res["unassigned"] == 2
            assert fake.mode[keys[2]] == -1 and fake.mode[keys[3]] == -1
            state = _get(dash.port, "cluster/assign/state?app=svc")
            assert sorted(state["unassigned"]) == sorted([keys[2], keys[3]])
            assert [g["machine"] for g in state["servers"]] == [keys[0]]
        finally:
            dash.stop()

    def test_failed_promote_reconfigures_no_clients(self, manual_clock):
        dash, fake, keys = self._dash(3)
        try:
            fake.dead.add(keys[0])
            code, res, _ = _post(
                dash.port, "cluster/assign/manage?app=svc",
                {"groups": [{"server": keys[0],
                             "clients": [keys[1], keys[2]]}]},
            )
            assert code == 200
            assert keys[0] in res["failed"]
            # fail-stop: the group's clients were never touched
            assert fake.mode[keys[1]] == -1 and fake.mode[keys[2]] == -1
            assert fake.client_cfg == {}
        finally:
            dash.stop()

    def test_state_reports_unreachable_and_orphan_clients(self, manual_clock):
        dash, fake, keys = self._dash(3)
        try:
            fake.dead.add(keys[0])
            # keys[1] points at a server that is not in this app
            fake.mode[keys[1]] = 0
            fake.client_cfg[keys[1]] = {"serverHost": "10.9.9.9",
                                        "serverPort": 1}
            state = _get(dash.port, "cluster/assign/state?app=svc")
            assert state["unknown"] == [keys[0]]
            assert keys[1] in state["unassigned"]  # orphan client
            assert keys[2] in state["unassigned"]
        finally:
            dash.stop()

    def test_transport_failure_is_unknown_not_unassigned(self, manual_clock):
        """A live client/server whose detail fetch fails must be 'unknown':
        acting on 'unassigned' would re-assign a clustered machine."""
        dash, fake, keys = self._dash(3)
        try:
            fake.mode[keys[0]] = 1  # server, but info fetch will fail
            fake.mode[keys[1]] = 0  # client, but config fetch will fail
            orig = fake.fetch_json

            def flaky(m, command, params=None):
                if m.key in (keys[0], keys[1]):
                    return None  # transport failure on the detail call only
                return orig(m, command, params)

            fake.fetch_json = flaky
            state = _get(dash.port, "cluster/assign/state?app=svc")
            assert sorted(state["unknown"]) == sorted([keys[0], keys[1]])
            assert state["unassigned"] == [keys[2]]
            assert state["servers"] == []
        finally:
            dash.stop()


class TestRuleValidation:
    """Server-side rule validation (checkEntityInternal analogs): malformed
    rules are rejected with a named reason BEFORE storing or pushing."""

    def test_validators_direct(self):
        from sentinel_tpu_torch.dashboard.validation import validate_rule

        ok = {
            "flow": {"resource": "r", "count": 5, "grade": 1},
            "degrade": {"resource": "r", "grade": 2, "count": 3,
                        "timeWindow": 10},
            "system": {"qps": 100},
            "authority": {"resource": "r", "limitApp": "a", "strategy": 0},
            "paramFlow": {"resource": "r", "paramIdx": 0, "count": 5},
            "gateway": {"resource": "r", "count": 5, "resourceMode": 0},
        }
        for t, rule in ok.items():
            assert validate_rule(t, rule) is None, (t, rule)
        bad = [
            ("flow", {"count": 5}, "resource"),
            ("flow", {"resource": "r", "grade": 7}, "grade"),
            ("flow", {"resource": "r", "count": -1}, "count"),
            ("flow", {"resource": "r", "strategy": 1}, "refResource"),
            ("flow", {"resource": "r", "count": "x"}, "count"),
            ("degrade", {"resource": "r", "grade": 0, "count": 1,
                         "timeWindow": 0}, "timeWindow"),
            ("degrade", {"resource": "r", "grade": 5, "count": 1,
                         "timeWindow": 1}, "strategy"),
            ("degrade", {"resource": "r", "grade": 0, "count": 1,
                         "timeWindow": 1, "slowRatioThreshold": 2},
             "slowRatioThreshold"),
            ("system", {}, "threshold"),
            ("system", {"highestCpuUsage": 3}, "highestCpuUsage"),
            ("authority", {"resource": "r", "limitApp": ""}, "limitApp"),
            ("paramFlow", {"resource": "r", "paramIdx": -1, "count": 1},
             "paramIdx"),
            ("paramFlow", {"resource": "r", "paramIdx": 0.5, "count": 1},
             "paramIdx"),
            ("gateway", {"resource": "r", "count": 1, "resourceMode": 9},
             "resourceMode"),
            ("flow", [], "JSON object"),
        ]
        for t, rule, needle in bad:
            err = validate_rule(t, rule)
            assert err and needle in err, (t, rule, err)

    def test_crud_rejects_invalid_before_any_push(self):
        from sentinel_tpu_torch.transport.command import CommandCenter

        dash = DashboardServer(port=0).start()
        cc = CommandCenter(port=0)
        cc.start()
        try:
            dash.apps.register(
                MachineInfo(app="svc", ip="127.0.0.1", port=cc.port)
            )
            out = _req(dash.port, "v1/rule?app=svc&type=flow", "POST",
                       {"resource": "r", "grade": 42})
            assert "grade" in out.get("error", "")
            # nothing was stored or pushed: the live agent has no rules
            assert _req(dash.port, "rules?app=svc&type=flow") == []
            # bulk push validates each element with its index
            out = _req(dash.port, "rules?app=svc&type=flow", "POST",
                       [{"resource": "a", "count": 1},
                        {"resource": "", "count": 1}])
            assert "rule[1]" in out.get("error", "")
            assert _req(dash.port, "rules?app=svc&type=flow") == []
        finally:
            cc.stop()
            dash.stop()

    def test_malformed_json_body_is_a_clean_error(self):
        from sentinel_tpu_torch.transport.command import CommandCenter

        dash = DashboardServer(port=0).start()
        cc = CommandCenter(port=0)
        cc.start()
        try:
            dash.apps.register(
                MachineInfo(app="svc", ip="127.0.0.1", port=cc.port)
            )
            for path, method in (("v1/rule?app=svc&type=flow", "POST"),
                                 ("v1/rule?app=svc&type=flow&id=1", "PUT"),
                                 ("rules?app=svc&type=flow", "POST")):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{dash.port}/{path}",
                    data=b"{not json", method=method,
                )
                with urllib.request.urlopen(req, timeout=5) as r:
                    out = json.loads(r.read())
                assert out.get("error") == "body is not valid JSON", (path, out)
        finally:
            cc.stop()
            dash.stop()


class TestHeartbeatFailover:
    def test_second_dashboard_receives_when_first_is_dead(self):
        """Multiple dashboard addresses are tried in order
        (HeartbeatSenderInitFunc's comma list): a dead first address must
        not lose the registration."""
        from sentinel_tpu_torch.transport.heartbeat import HeartbeatSender

        dash = DashboardServer(port=0).start()
        try:
            hb = HeartbeatSender(
                dashboard_addrs=["127.0.0.1:1", f"127.0.0.1:{dash.port}"],
                command_port=4321, client_ip="127.0.0.1",
            )
            assert hb.send_once() is True
            machines = [
                m for app in dash.apps.apps()
                for m in dash.apps.machines(app)
            ]
            assert [m.port for m in machines] == [4321]
        finally:
            dash.stop()

    def test_all_dead_reports_false(self):
        from sentinel_tpu_torch.transport.heartbeat import HeartbeatSender

        hb = HeartbeatSender(
            dashboard_addrs=["127.0.0.1:1", "127.0.0.1:2"],
            command_port=1, client_ip="127.0.0.1",
        )
        assert hb.send_once() is False


class TestDynamicRulePlugins:
    """v2 pluggable provider/publisher route (FlowControllerV2 analog)."""

    def test_store_publish_and_agent_convergence(self, tmp_path):
        """Dashboard publishes to a store; the agent converges by WATCHING
        the same store through its datasource — no dashboard→machine push
        (the config-center model of DynamicRulePublisher.java:22)."""
        import time

        from sentinel_tpu_torch.dashboard.dynamic_rules import FileRuleStore
        from sentinel_tpu_torch.datasource import (
            FileRefreshableDataSource,
            flow_rules_from_json,
        )
        from sentinel_tpu_torch.local import FlowRuleManager

        store = FileRuleStore(str(tmp_path))
        dash = DashboardServer(
            port=0, rule_plugins=store.plugins(("flow",))
        ).start()
        try:
            # publish through v2 — note: NO machines are registered; the
            # store pair never needs the fleet reachable from the console
            code, out, _ = _post(
                dash.port, "v2/rules?app=demo&type=flow",
                [{"resource": "v2_res", "count": 11}],
            )
            assert out == {"published": 1}
            assert _get(dash.port, "v2/rules?app=demo&type=flow") == [
                {"resource": "v2_res", "count": 11}
            ]
            ds = FileRefreshableDataSource(
                store.path_for("demo-flow-rules"), flow_rules_from_json,
                refresh_interval_s=0.05,
            )
            FlowRuleManager.register_property(ds.property)
            ds.start()
            try:
                rules = FlowRuleManager.get_rules("v2_res")
                assert rules and rules[0].count == 11
                _post(
                    dash.port, "v2/rules?app=demo&type=flow",
                    [{"resource": "v2_res", "count": 23}],
                )
                for _ in range(100):
                    rules = FlowRuleManager.get_rules("v2_res")
                    if rules and rules[0].count == 23:
                        break
                    time.sleep(0.02)
                else:
                    raise AssertionError(
                        "agent never converged on the published update"
                    )
            finally:
                ds.close()
        finally:
            dash.stop()

    def test_v2_validates_and_defaults_empty(self, tmp_path):
        from sentinel_tpu_torch.dashboard.dynamic_rules import FileRuleStore

        store = FileRuleStore(str(tmp_path))
        dash = DashboardServer(
            port=0, rule_plugins=store.plugins(("flow", "degrade"))
        ).start()
        try:
            # nothing published yet → empty authoritative list, not an error
            assert _get(dash.port, "v2/rules?app=demo&type=degrade") == []
            # a malformed rule is rejected BEFORE reaching the publisher
            code, out, _ = _post(
                dash.port, "v2/rules?app=demo&type=flow",
                [{"count": 5}],  # missing resource
            )
            assert "error" in out
            assert _get(dash.port, "v2/rules?app=demo&type=flow") == []
        finally:
            dash.stop()

    def test_v2_api_fallback_pushes_to_machines(self):
        """Without a plugin the v2 route falls back to the direct
        Api pair — same fleet behavior as v1 behind the v2 contract."""
        from sentinel_tpu_torch.local import FlowRuleManager
        from sentinel_tpu_torch.transport.command import CommandCenter

        dash = DashboardServer(port=0).start()
        cc = CommandCenter(port=0)
        cc.start()
        try:
            dash.apps.register(
                MachineInfo(app="svc", ip="127.0.0.1", port=cc.port)
            )
            code, out, _ = _post(
                dash.port, "v2/rules?app=svc&type=flow",
                [{"resource": "v2_direct", "count": 3}],
            )
            assert out == {"published": 1}
            assert any(
                r.resource == "v2_direct" and r.count == 3
                for r in FlowRuleManager.all_rules()
            )
            fetched = _get(dash.port, "v2/rules?app=svc&type=flow")
            assert any(r["resource"] == "v2_direct" for r in fetched)
        finally:
            cc.stop()
            dash.stop()


class TestFailedPromotion:
    """The port does not lose a promotion that failed on the machine: the
    command center answers it with an error, and the dashboard's answer
    names it (an unreachable machine keeps the reference's answer,
    ``TestClusterAssign::test_assign_aborts_when_server_unreachable``)."""

    @staticmethod
    def broken(server_cls, host, port):
        raise RuntimeError("the token service failed to build")

    def test_failed_promotion_shows_in_the_answer(self, manual_clock):
        from sentinel_tpu_torch.cluster import api as cluster_api
        from sentinel_tpu_torch.transport.command import CommandCenter

        cluster_api.reset_for_tests()
        dash = DashboardServer(port=0).start()
        cc = CommandCenter(port=0, server_factory=self.broken)
        cc.start()
        key = f"127.0.0.1:{cc.port}"
        try:
            _post(dash.port, "registry/machine",
                  {"app": "svc", "ip": "127.0.0.1", "port": cc.port})
            code, result, _ = _post(dash.port, "cluster/assign?app=svc",
                                    {"server": key, "tokenPort": 0})
            assert code == 200
            assert "no clients were reconfigured" in result["error"]
            assert "failed to build" in result["error"]
            code, res, _ = _post(
                dash.port, "cluster/assign/manage?app=svc",
                {"groups": [{"server": key, "clients": []}]},
            )
            assert res["failed"] == [key]
            assert "failed to build" in res["errors"][key]
            assert "500" in res["errors"][key]
            assert _get(dash.port, "cluster/state?app=svc")[0]["mode"] == -1
        finally:
            cc.stop()
            dash.stop()
            cluster_api.reset_for_tests()

    def test_unreachable_machine_names_no_error(self, manual_clock):
        dash = DashboardServer(port=0).start()
        try:
            _post(dash.port, "registry/machine",
                  {"app": "svc", "ip": "127.0.0.1", "port": 1})
            code, res, _ = _post(
                dash.port, "cluster/assign/manage?app=svc",
                {"groups": [{"server": "127.0.0.1:1", "clients": []}]},
            )
            assert res["failed"] == ["127.0.0.1:1"]
            assert "errors" not in res
        finally:
            dash.stop()
