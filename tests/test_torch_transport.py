"""The port's command handlers behind the HA, metrics and trace surfaces,
and ``ClusterStateManager`` (``sentinel_tpu_torch.ha.manager``), on the
CPU.

Reruns, case for case, against the port's copies:

- ``tests/test_ha.py::TestClusterStateManager`` (client, server and off
  transitions; the snapshot restored on promotion), with the manager's
  ``server_factory`` asking for a CPU service;
- ``tests/test_ha_snapshot.py::TestSnapshotTransportCommand``
  (``cluster/server/snapshot`` fetch, save, restore, its errors);
- ``tests/test_replication.py::TestHeartbeatBackoff``;
- the handler cases of ``tests/test_server_metrics.py``
  (``TestLiveServerSurface``: the door's ``metrics_port`` scrape, the
  ``clusterServerStats`` and ``cluster/server/profiler`` commands),
  ``tests/test_timeline.py::TestMetricCommand`` and
  ``tests/test_trace.py::TestTransportCommands``.

Then the handlers the port reads without probing: ``cluster/server/metrics``
answers ``{}`` with a token client in the service's place, the promote and
snapshot status commands read the door's own attributes.
"""

import json
import os
import re
import shutil
import threading
import time
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="no C++ compiler for the native library (doors)",
)

import torch_parity  # noqa: E402,F401  (stat logs to a temp dir)
from sentinel_tpu_torch.cluster import api as cluster_api  # noqa: E402
from sentinel_tpu_torch.cluster.client import TokenClient  # noqa: E402
from sentinel_tpu_torch.cluster.server import TokenServer  # noqa: E402
from sentinel_tpu_torch.cluster.token_service import (  # noqa: E402
    ClusterParamFlowRule,
    DefaultTokenService,
    TokenResult,
)
from sentinel_tpu_torch.core import clock as t_clock  # noqa: E402
from sentinel_tpu_torch.engine import ClusterFlowRule, EngineConfig  # noqa: E402
from sentinel_tpu_torch.engine.decide import TokenStatus  # noqa: E402
from sentinel_tpu_torch.engine.rules import ThresholdMode  # noqa: E402
from sentinel_tpu_torch.ha.manager import ClusterStateManager  # noqa: E402
from sentinel_tpu_torch.ha.snapshot import SNAPSHOT_VERSION  # noqa: E402
from sentinel_tpu_torch.metrics.ha import reset_ha_metrics_for_tests  # noqa: E402
from sentinel_tpu_torch.metrics.server import (  # noqa: E402
    reset_server_metrics_for_tests,
)
from sentinel_tpu_torch.metrics.timeline import timeline  # noqa: E402
from sentinel_tpu_torch.trace import blackbox, ring  # noqa: E402
from sentinel_tpu_torch.trace.slo import (  # noqa: E402
    reset_slo_plane_for_tests,
    slo_plane,
)
from sentinel_tpu_torch.transport import handlers as H  # noqa: E402
from sentinel_tpu_torch.transport.command import _route, get_command  # noqa: E402

CFG = EngineConfig(max_flows=64, max_namespaces=4, batch_size=64)
G = ThresholdMode.GLOBAL
T0 = 1_754_000_000  # an arbitrary fixed wall second (test_timeline.py)


def cpu_server(server_cls, host, port):
    return server_cls(DefaultTokenService(CFG, device="cpu"), host=host,
                      port=port)


@pytest.fixture
def manual_clock():
    mc = t_clock.ManualClock()
    prev = t_clock.set_clock(mc)
    yield mc
    t_clock.set_clock(prev)


@pytest.fixture(autouse=True)
def fresh():
    reset_server_metrics_for_tests()
    reset_ha_metrics_for_tests()
    ring.reset_for_tests()
    blackbox.reset_for_tests()
    yield
    H.apply_cluster_mode(-1)
    cluster_api.reset_for_tests()
    reset_server_metrics_for_tests()
    reset_ha_metrics_for_tests()
    ring.reset_for_tests()
    blackbox.reset_for_tests()
    reset_slo_plane_for_tests()


class StubClient:
    """client_factory stand-in with the port ``TokenClient``'s surface."""

    def __init__(self, host, port, timeout_ms=20, namespace="default"):
        self.host = host
        self.port = port
        self.alive = True
        self.closed = False
        self.on_brownout = None
        self.consecutive_failures = 0

    def request_token(self, flow_id, acquire=1, prioritized=False):
        return TokenResult(TokenStatus.OK, remaining=int(self.port))

    def request_batch_arrays(self, flow_ids, acquires=None, prios=None,
                             timeout_ms=None):
        n = len(flow_ids)
        return (np.full(n, int(TokenStatus.OK), np.int8),
                np.full(n, int(self.port), np.int32), np.zeros(n, np.int32))

    def ping_ex(self, namespace=None):
        return True

    def lease_stats(self):
        return {}

    def close(self):
        self.closed = True


class TestClusterStateManager:
    def test_to_client_installs_failover_client(self):
        manager = ClusterStateManager(cpu_server)
        client = manager.to_client(
            [("a", 1), ("b", 2)], client_factory=StubClient
        )
        assert cluster_api.get_mode() == cluster_api.ClusterMode.CLIENT
        assert cluster_api._pick_service() is client
        assert client.request_token(1).ok

    def test_to_server_then_to_client_rewires_live(self):
        manager = ClusterStateManager(cpu_server)
        service = manager.to_server(token_port=0)
        assert cluster_api.get_mode() == cluster_api.ClusterMode.SERVER
        assert cluster_api.get_embedded_server() is service
        client = manager.to_client([("a", 1)], client_factory=StubClient)
        assert cluster_api.get_mode() == cluster_api.ClusterMode.CLIENT
        assert cluster_api.get_embedded_server() is None
        assert cluster_api._pick_service() is client

    def test_to_off_drops_client(self):
        manager = ClusterStateManager(cpu_server)
        client = manager.to_client([("a", 1)], client_factory=StubClient)
        manager.to_off()
        assert manager.current_mode() == cluster_api.ClusterMode.NOT_STARTED
        assert cluster_api._pick_service() is None
        assert all(m.client.closed for m in client._members)

    def test_server_restores_snapshot_on_promotion(self, tmp_path):
        from sentinel_tpu_torch.ha.snapshot import save_snapshot

        donor = DefaultTokenService(CFG, device="cpu")
        donor.load_rules([ClusterFlowRule(55, 20.0, G)])
        donor.request_token(55)
        save_snapshot(donor, str(tmp_path))
        manager = ClusterStateManager(cpu_server)
        service = manager.to_server(
            token_port=0, snapshot_dir=str(tmp_path)
        )
        assert [r.flow_id for r in service.current_rules()] == [55]

    def test_status_shape(self):
        manager = ClusterStateManager(cpu_server)
        manager.to_client([("a", 1)], client_factory=StubClient)
        status = manager.status()
        assert status["mode"] == "CLIENT"
        assert status["endpoints"][0]["endpoint"] == "a:1"

    def test_status_of_a_server_and_of_a_plain_client(self):
        # the port reads the failover client's health by its type: a plain
        # token client in the slot has no endpoints to show
        manager = ClusterStateManager(cpu_server)
        manager.to_server(token_port=0)
        status = manager.status()
        assert status["mode"] == "SERVER"
        assert status["serverPort"] == H._EMBEDDED_SERVER["server"].port
        assert "endpoints" not in status
        cluster_api.set_client(StubClient("c", 3))
        assert "endpoints" not in manager.status()


RULE_A = ClusterFlowRule(101, 50.0, G)
RULE_B = ClusterFlowRule(202, 50.0, G)
PARAM_RULE = ClusterParamFlowRule(301, 10.0, None, "default")


def _warm_service(manual_clock):
    """A service with traffic on two flow rules and one param rule."""
    svc = DefaultTokenService(CFG, device="cpu")
    svc.load_rules([RULE_A, RULE_B])
    svc.load_param_rules([PARAM_RULE])
    for _ in range(4):
        assert svc.request_token(101).ok
    for _ in range(2):
        assert svc.request_token(202).ok
    assert svc.request_params_token(301, 1, [7, 8]).ok
    return svc


class TestSnapshotTransportCommand:
    def test_not_a_server_error(self):
        out = H.cmd_cluster_server_snapshot({}, "")
        assert "error" in out

    def test_fetch_then_restore_via_body(self, manual_clock):
        donor = _warm_service(manual_clock)
        cluster_api.set_embedded_server(donor)
        doc = H.cmd_cluster_server_snapshot({"action": "fetch"}, "")
        assert doc["version"] == SNAPSHOT_VERSION
        heir = DefaultTokenService(CFG, device="cpu")
        cluster_api.set_embedded_server(heir)
        out = H.cmd_cluster_server_snapshot(
            {"action": "restore"}, json.dumps(doc)
        )
        assert out == "success"
        assert (
            heir.metrics_snapshot()[101]["pass_qps"]
            == donor.metrics_snapshot()[101]["pass_qps"]
        )

    def test_save_and_restore_via_dir(self, tmp_path, manual_clock):
        donor = _warm_service(manual_clock)
        cluster_api.set_embedded_server(donor)
        out = H.cmd_cluster_server_snapshot(
            {"action": "save", "dir": str(tmp_path)}, ""
        )
        assert os.path.exists(out["path"])
        heir = DefaultTokenService(CFG, device="cpu")
        cluster_api.set_embedded_server(heir)
        assert H.cmd_cluster_server_snapshot(
            {"action": "restore", "dir": str(tmp_path)}, ""
        ) == "success"
        assert [r.flow_id for r in heir.current_rules()] == [101, 202]

    def test_save_without_dir_errors(self, manual_clock):
        cluster_api.set_embedded_server(_warm_service(manual_clock))
        out = H.cmd_cluster_server_snapshot({"action": "save"}, "")
        assert "error" in out

    def test_bad_doc_reports_error(self, manual_clock):
        cluster_api.set_embedded_server(_warm_service(manual_clock))
        out = H.cmd_cluster_server_snapshot(
            {"action": "restore"}, json.dumps({"version": 99})
        )
        assert "error" in out

    def test_status_and_promote_read_the_door(self, tmp_path, manual_clock):
        # the door's own attributes, where the reference probes them
        H.apply_cluster_mode(1, 0, lambda cls, host, port: cls(
            DefaultTokenService(CFG, device="cpu"), host=host, port=port,
            snapshot_dir=str(tmp_path), snapshot_period_s=3600.0))
        out = H.cmd_cluster_server_snapshot({"action": "status"}, "")
        assert out["dir"] == str(tmp_path) and out["periodS"] == 3600.0
        assert H.cmd_cluster_server_promote({"action": "status"}, "") == {
            "isStandby": False}
        assert "not a standby" in H.cmd_cluster_server_promote(
            {"action": "promote"}, "")["error"]
        prof = H.cmd_cluster_server_profiler({}, "")
        assert prof.get("profiling") is False


class TestHeartbeatBackoff:
    def test_interval_backs_off_with_jitter_and_resets(self):
        from sentinel_tpu_torch.transport.heartbeat import HeartbeatSender

        hb = HeartbeatSender(dashboard_addrs=["127.0.0.1:1"], interval_ms=1000)
        assert hb._interval_s() == 1.0  # healthy: exact cadence
        hb._consecutive_failures = 1
        for _ in range(20):
            assert 2.0 * 0.75 <= hb._interval_s() <= 2.0 * 1.25
        hb._consecutive_failures = 50
        for _ in range(20):
            assert 10.0 * 0.75 <= hb._interval_s() <= 10.0 * 1.25  # capped
        hb._consecutive_failures = 0
        assert hb._interval_s() == 1.0

    def test_loop_resets_on_success(self):
        from sentinel_tpu_torch.transport.heartbeat import HeartbeatSender

        hb = HeartbeatSender(dashboard_addrs=["x"], interval_ms=10)
        hb.send_once = lambda: True
        hb._consecutive_failures = 5
        hb._stop.clear()
        t = threading.Thread(target=hb._loop, daemon=True)
        t.start()
        deadline = time.monotonic() + 2.0
        while hb._consecutive_failures and time.monotonic() < deadline:
            time.sleep(0.01)
        hb.stop()
        assert hb._consecutive_failures == 0


class TestLiveServerSurface:
    def test_scrape_and_stats_command_reflect_traffic(self):
        svc = DefaultTokenService(CFG, device="cpu")
        svc.load_rules([
            ClusterFlowRule(flow_id=7, count=5.0, mode=G, namespace="ns-a")
        ])
        server = TokenServer(svc, port=0, metrics_port=0, batch_window_ms=0.5)
        server.start()
        client = None
        try:
            client = TokenClient("127.0.0.1", server.port, timeout_ms=2000)
            oks = sum(1 for _ in range(8) if client.request_token(7).ok)
            with urllib.request.urlopen(
                f"http://127.0.0.1:{server.metrics_port}/metrics", timeout=5
            ) as rsp:
                ctype = rsp.headers.get("Content-Type", "")
                body = rsp.read().decode()
            assert "version=0.0.4" in ctype
            assert body.endswith("\n")
            assert "# EOF" not in body
            assert (
                f'sentinel_server_verdicts_total{{verdict="pass",'
                f'namespace="ns-a"}} {oks}' in body
            )
            decide = re.search(
                r"^sentinel_server_decide_ms_count (\d+)$", body, re.M
            )
            assert decide and int(decide.group(1)) > 0
            batches = re.search(
                r"^sentinel_server_batch_size_count (\d+)$", body, re.M
            )
            assert batches and int(batches.group(1)) > 0
            assert re.search(r"^sentinel_server_queue_depth \d", body, re.M)
            assert re.search(r"^sentinel_server_connections \d", body, re.M)
            assert "sentinel_pass_total" in body

            stats = get_command("clusterServerStats")({}, "")
            got = {
                (v["verdict"], v["namespace"]): v["count"]
                for v in stats["verdicts"]
            }
            assert got[("pass", "ns-a")] == oks
            assert stats["stages"]["decide_ms"]["count"] == int(
                decide.group(1)
            )
            assert "queue_depth" in stats["gauges"]
            assert stats["buildInfo"]["torch_backend"] in ("cpu", "cuda")

            prof = get_command("cluster/server/profiler")({}, "")
            assert prof.get("profiling") is False
        finally:
            if client is not None:
                client.close()
            server.stop()
            svc.close()

    def test_cluster_server_metrics_of_a_client_is_empty(self):
        # a token client in the service's place (client mode) answers the
        # reference's {} (by type, not by probing for metrics_snapshot)
        assert H.cmd_cluster_server_metrics({}, "") == {}
        cluster_api.set_client(StubClient("127.0.0.1", 1))
        assert H.cmd_cluster_server_metrics({}, "") == {}
        svc = DefaultTokenService(CFG, device="cpu")
        svc.load_rules([ClusterFlowRule(7, 5.0, G)])
        svc.request_token(7)
        cluster_api.set_embedded_server(svc)
        assert set(H.cmd_cluster_server_metrics({}, "")) == {"7"}


class TestMetricCommand:
    def test_command_queries_by_range_and_namespace(self):
        tl = timeline()
        tl.record("a", n_pass=3, now_s=T0)
        tl.record("b", n_block=2, now_s=T0 + 1)
        out = H.cmd_cluster_server_metric(
            {"startTime": str(T0 * 1000),
             "endTime": str((T0 + 1) * 1000)}, "")
        assert [(s["namespace"], s["pass"], s["block"]) for s in out] == [
            ("a", 3, 0), ("b", 0, 2)]
        only_b = H.cmd_cluster_server_metric(
            {"startTime": "0", "endTime": str((T0 + 9) * 1000),
             "namespace": "b"}, "")
        assert len(only_b) == 1 and only_b[0]["namespace"] == "b"

    def test_command_default_range_and_max_lines(self):
        tl = timeline()
        for d in range(5):
            tl.record("a", n_pass=1, now_s=T0 + d)
        out = H.cmd_cluster_server_metric(
            {"startTime": str(T0 * 1000), "endTime": str((T0 + 9) * 1000),
             "maxLines": "2"}, "")
        assert len(out) == 2

    def test_stats_command_exposes_timeline_block(self):
        out = H.cmd_cluster_server_stats({}, "")
        assert "timeline" in out
        assert set(out["timeline"]) == {
            "windowSeconds", "namespaces", "lastSecondMs", "fileDir"}


def _route_json(path, params, body=""):
    code, payload, ctype = _route("GET", path, params, body)
    assert code == 200
    return json.loads(payload)


class TestTransportCommands:
    def test_trace_arm_status_disarm(self):
        out = _route_json("cluster/server/trace",
                          {"action": "arm", "sample": "0.5"})
        assert out["armed"] is True and out["sample"] == 0.5
        assert ring.ARMED is True
        out = _route_json("cluster/server/trace", {"action": "disarm"})
        assert out["armed"] is False
        assert ring.ARMED is False

    def test_trace_spans_and_blackbox(self, tmp_path):
        ring.arm(sample=1.0)
        ring.record(ring.CLIENT_IN, xid=77)
        ring.record(ring.REPLY_OUT, xid=77)
        out = _route_json("cluster/server/trace",
                          {"action": "spans", "xid": "77"})
        assert out["complete"] is True
        out = _route_json("cluster/server/trace",
                          {"action": "spans", "xid": "0x4D"})  # hex = 77
        assert out["xid"] == 77
        out = _route_json("cluster/server/trace", {"action": "spans"})
        assert out["completeness"]["spans"] == 1
        out = _route_json("cluster/server/trace",
                          {"action": "spans", "dir": str(tmp_path)})
        assert json.load(open(out["path"]))["schema"] == \
            "sentinel-trace-spans/1"
        out = _route_json("cluster/server/trace",
                          {"action": "blackbox", "dir": str(tmp_path)})
        assert json.load(open(out["path"]))["schema"] == "sentinel-blackbox/1"
        blackbox.reset_for_tests()
        out = _route_json("cluster/server/trace", {"action": "blackbox"})
        assert "error" in out

    def test_slo_local_and_fleet(self):
        slo_plane().record("ns-a", 5.0, n=10)
        out = _route_json("cluster/server/slo", {"action": "local"})
        assert "ns-a" in out["tenants"]
        pods = json.dumps([out, {"slo": out}, "garbage"])
        merged = _route_json("cluster/server/slo", {"action": "fleet"},
                             body=pods)
        assert merged["pods"] == 3
        assert merged["tenants"]["ns-a"]["count"] == 20

    def test_cluster_server_stats_carries_trace_slo_build(self):
        out = _route_json("clusterServerStats", {})
        assert "armed" in out["trace"]
        assert "tenants" in out["slo"]
        assert out["buildInfo"]["version"]
