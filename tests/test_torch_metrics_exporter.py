"""The port's metric extension SPI and Prometheus exporter
(``sentinel_tpu_torch.metrics.exporter``) on the CPU.

Reruns, case for case, the reference's ``tests/test_metrics_exporter.py``
against the port's copies (``test_command_center_route`` through the port's
command center), and
``tests/test_rebalance.py::test_exporter_renders_rebalance_and_snapshot_error_series``.
The port's ``build_info`` names the torch backend under ``torch_backend``
where the reference names JAX's under ``jax_backend``.

The port's copy of ``test_slo_series_render_after_traffic`` does not depend
on what else runs in the process (ROADMAP §C: the reference's failed in
whole-suite runs): it renders a plane built with the objective it asserts,
and records under tenant names no other test uses.

Then both doors' ``metrics_port``: each serves the exposition on its own
port, with the token server's verdict counters of the traffic it served,
and a port move keeps the exporter.
"""

import re
import shutil
import urllib.request

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="no C++ compiler for the native library (local windows, doors)",
)

import torch_parity  # noqa: E402,F401  (stat logs to a temp dir)
from sentinel_tpu_torch import local as sentinel  # noqa: E402
from sentinel_tpu_torch.core import clock as t_clock  # noqa: E402
from sentinel_tpu_torch.local import BlockException  # noqa: E402
from sentinel_tpu_torch.local.chain import (  # noqa: E402
    reset_cluster_nodes_for_tests,
)
from sentinel_tpu_torch.local.flow import FlowRule, FlowRuleManager  # noqa: E402
from sentinel_tpu_torch.metrics import (  # noqa: E402
    MetricExtension,
    PrometheusExporter,
    clear_extensions_for_tests,
    register_extension,
    render,
)


class Recorder(MetricExtension):
    def __init__(self):
        self.events = []

    def add_pass(self, resource, n, args):
        self.events.append(("pass", resource, n))

    def add_block(self, resource, n, origin, error, args):
        self.events.append(("block", resource, n, type(error).__name__))

    def add_success(self, resource, n, args):
        self.events.append(("success", resource, n))

    def add_rt(self, resource, rt_ms, args):
        self.events.append(("rt", resource))

    def add_exception(self, resource, n, error):
        self.events.append(("exception", resource, n))

    def increase_thread_num(self, resource, args):
        self.events.append(("thread+", resource))

    def decrease_thread_num(self, resource, args):
        self.events.append(("thread-", resource))


@pytest.fixture(autouse=True)
def clean():
    mc = t_clock.ManualClock()
    prev = t_clock.set_clock(mc)
    reset_cluster_nodes_for_tests()
    clear_extensions_for_tests()
    FlowRuleManager.load_rules([])
    yield mc
    clear_extensions_for_tests()
    FlowRuleManager.load_rules([])
    reset_cluster_nodes_for_tests()
    t_clock.set_clock(prev)


class TestExtensionSpi:
    def test_pass_and_exit_callbacks(self):
        rec = Recorder()
        register_extension(rec)
        with sentinel.entry("api"):
            pass
        kinds = [e[0] for e in rec.events]
        assert kinds == ["pass", "thread+", "success", "rt", "thread-"]
        assert all(e[1] == "api" for e in rec.events)

    def test_block_callback(self):
        FlowRuleManager.load_rules([FlowRule(resource="api", count=0.0)])
        rec = Recorder()
        register_extension(rec)
        with pytest.raises(BlockException):
            with sentinel.entry("api"):
                pass
        assert ("block", "api", 1, "FlowException") in rec.events
        assert not any(e[0] == "pass" for e in rec.events)

    def test_exception_callback(self):
        rec = Recorder()
        register_extension(rec)
        try:
            with sentinel.entry("api"):
                raise RuntimeError("boom")
        except RuntimeError:
            pass
        assert ("exception", "api", 1) in rec.events


def _traffic():
    FlowRuleManager.load_rules([FlowRule(resource="api", count=2.0)])
    for _ in range(4):
        try:
            with sentinel.entry("api"):
                pass
        except BlockException:
            pass


def _scrape(port):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/metrics", timeout=5
    ) as resp:
        return resp.headers["Content-Type"], resp.read().decode()


class TestPrometheusExporter:
    def test_render_series(self):
        _traffic()
        text = render()
        assert 'sentinel_pass_qps{resource="api"} 2' in text
        assert 'sentinel_block_qps{resource="api"} 2' in text
        assert 'sentinel_concurrency{resource="api"} 0' in text
        assert "# TYPE sentinel_rt_avg_ms gauge" in text

    def test_label_escaping(self):
        with sentinel.entry('we"ird'):
            pass
        assert 'resource="we\\"ird"' in render()

    def test_http_scrape(self):
        _traffic()
        exporter = PrometheusExporter(host="127.0.0.1", port=0).start()
        try:
            ctype, body = _scrape(exporter.port)
            assert ctype.startswith("text/plain")
            assert 'sentinel_pass_qps{resource="api"} 2' in body
        finally:
            exporter.stop()

    def test_command_center_route(self):
        import sentinel_tpu_torch.transport.handlers  # noqa: F401
        from sentinel_tpu_torch.transport.command import _route

        _traffic()
        code, body, ctype = _route("GET", "metric/prometheus", {}, "")
        assert code == 200
        assert "sentinel_pass_qps" in body
        assert ctype.startswith("text/plain")  # exposition format, not JSON


class TestBuildInfoAndSloSeries:
    """The identity stamp and the per-tenant SLO plane ride the same
    exposition body as everything else."""

    @pytest.fixture(autouse=True)
    def clean_slo(self):
        from sentinel_tpu_torch.trace.slo import reset_slo_plane_for_tests

        reset_slo_plane_for_tests()
        yield
        reset_slo_plane_for_tests()

    def test_build_info_series(self):
        from sentinel_tpu_torch.metrics.exporter import build_info

        info = build_info()
        assert set(info) == {"version", "wire_rev", "torch_backend"}
        assert info["torch_backend"] == (
            "cuda" if torch.cuda.is_available() else "cpu")
        text = render()
        assert f'version="{info["version"]}"' in text
        assert f'wire_rev="{info["wire_rev"]}"' in text
        assert f'torch_backend="{info["torch_backend"]}"' in text
        assert "labels carry version, wire rev, torch backend" in text
        assert "# TYPE sentinel_build_info gauge" in text
        assert "sentinel_server_uptime_seconds " in text

    def test_build_info_is_the_reference_version(self):
        import sentinel_tpu

        from sentinel_tpu_torch.metrics.exporter import build_info

        assert build_info()["version"] == sentinel_tpu.__version__

    def test_uptime_advances(self):
        from sentinel_tpu_torch.metrics.exporter import uptime_seconds

        assert uptime_seconds() > 0

    def test_slo_series_render_after_traffic(self, monkeypatch):
        from sentinel_tpu_torch.trace import slo

        plane = slo.SloPlane(objective_ms=2.0, rt_objective_ms=100.0)
        monkeypatch.setattr(slo, "_PLANE", plane)
        plane.record("port-slo-a", 5.0, n=10)  # all over the 2ms objective
        plane.record_shed("port-slo-b", "overload", n=3)
        text = render()
        assert "sentinel_slo_objective_ms 2" in text
        assert 'sentinel_slo_latency_ms_count{namespace="port-slo-a"} 10' \
            in text
        assert ('sentinel_slo_burn_rate{namespace="port-slo-a",window="1m"} '
                '100') in text
        assert ('sentinel_slo_shed_total{namespace="port-slo-b",'
                'reason="overload"} 3') in text

    def test_slo_idle_renders_objective_only(self):
        text = render()
        assert "sentinel_slo_objective_ms" in text
        assert "sentinel_slo_burn_rate" not in text
        assert "sentinel_slo_shed_total" not in text


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"      # metric name
    r"(\{[^{}]*\})?"                     # optional label set
    r" (-?[0-9.eE+]+|\+Inf|-Inf|NaN)$"  # value
)


def _parse_exposition(text):
    """(helps, types, samples) of a 0.0.4 text exposition, asserting the
    invariants a strict scraper enforces as it goes."""
    helps, types, samples = {}, {}, []
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# HELP "):
            name = line.split(" ", 3)[2]
            assert name not in helps, f"duplicate HELP for family {name}"
            helps[name] = line
        elif line.startswith("# TYPE "):
            parts = line.split(" ")
            name, kind = parts[2], parts[3]
            assert name not in types, f"duplicate TYPE for family {name}"
            assert kind in ("counter", "gauge", "histogram", "summary",
                            "untyped"), f"bad TYPE kind {kind} for {name}"
            types[name] = kind
        elif line.startswith("#"):
            continue
        else:
            m = _SAMPLE_RE.match(line)
            assert m, f"unparseable sample line: {line!r}"
            samples.append((m.group(1), m.group(2) or "", m.group(3)))
    return helps, types, samples


def _family_of(sample_name, types):
    if sample_name in types:
        return sample_name
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            base = sample_name[: -len(suffix)]
            if types.get(base) in ("histogram", "summary"):
                return base
    return None


class TestExpositionConformance:
    """Strict-parser conformance over the full scrape body, including the
    outcome and per-flow RT series fed from the service's outcome
    columns."""

    @pytest.fixture(autouse=True)
    def clean_slo(self):
        from sentinel_tpu_torch.trace.slo import reset_slo_plane_for_tests

        reset_slo_plane_for_tests()
        yield
        reset_slo_plane_for_tests()

    def _drive(self):
        from sentinel_tpu_torch.cluster.token_service import (
            ClusterFlowRule,
            DefaultTokenService,
        )
        from sentinel_tpu_torch.engine.config import EngineConfig

        FlowRuleManager.load_rules([FlowRule(resource="api", count=100.0)])
        with sentinel.entry("api"):
            pass
        svc = DefaultTokenService(EngineConfig(max_flows=32), device="cpu")
        svc.load_rules([
            ClusterFlowRule(flow_id=11, namespace="nsA", count=100.0),
            ClusterFlowRule(flow_id=22, namespace="nsB", count=100.0),
        ])
        svc.report_outcomes([11, 11, 22, 22], [3, 5, 8, 13],
                            [False, False, True, False])
        svc.report_outcomes([11, 999], [-4, 7], [False, False])  # drops too
        return svc

    def test_full_scrape_is_conformant(self):
        svc = self._drive()
        text = render()
        assert text.endswith("\n") and "# EOF" not in text  # 0.0.4, not OM
        helps, types, samples = _parse_exposition(text)
        assert set(helps) == set(types), set(helps) ^ set(types)
        for name, labelset, value in samples:
            fam = _family_of(name, types)
            assert fam is not None, f"sample {name} has no declared family"
            if labelset:
                body = labelset[1:-1]
                assert body == "" or all(
                    "=" in pair for pair in body.split('",')
                ), f"malformed labels on {name}: {labelset}"
            float(value.replace("+Inf", "inf").replace("-Inf", "-inf"))
        for fam, kind in types.items():
            if kind == "counter":
                assert fam.endswith("_total"), fam
        del svc

    def test_outcome_families_present_with_headers(self):
        svc = self._drive()
        _, types, samples = _parse_exposition(render())
        for fam in (
            "sentinel_outcome_reported_total",
            "sentinel_outcome_exceptions_total",
            "sentinel_outcome_batches_total",
            "sentinel_outcome_rt_sum_ms_total",
            "sentinel_outcome_dropped_total",
            "sentinel_flow_complete_qps",
            "sentinel_flow_exception_qps",
            "sentinel_flow_rt_avg_ms",
            "sentinel_flow_rt_p99_ms",
            "sentinel_slo_rt_ms",
            "sentinel_slo_exceptions_total",
        ):
            assert fam in types, f"family {fam} not declared"
        names = {s[0] for s in samples}
        assert "sentinel_flow_rt_p99_ms" in names
        assert "sentinel_slo_rt_ms_bucket" in names
        del svc

    def test_multi_tenant_histograms_single_header(self):
        svc = self._drive()
        text = render()
        assert text.count("# TYPE sentinel_slo_rt_ms histogram") == 1
        assert text.count("# TYPE sentinel_slo_latency_ms histogram") <= 1
        del svc


def test_exporter_renders_rebalance_and_snapshot_error_series():
    from sentinel_tpu_torch.metrics import exporter

    body = exporter.render()
    assert "sentinel_assignment_snapshot_errors_total" in body
    assert "sentinel_rebalance_moves_total" in body
    assert "sentinel_rebalance_state_bytes_total" in body
    assert "sentinel_rebalance_redirects_total" in body
    assert "sentinel_rebalance_move_duration_ms" in body


@pytest.mark.parametrize("door", ["native", "asyncio"])
def test_door_metrics_port_serves_the_exposition(door):
    """Both doors take ``metrics_port=`` as the reference's do: 0 resolves
    to a bound port at start, the scrape carries the verdicts the door
    served, a port move keeps the exporter on its port, and stop closes
    it."""
    from sentinel_tpu_torch.cluster.client import TokenClient
    from sentinel_tpu_torch.cluster.server import TokenServer
    from sentinel_tpu_torch.cluster.server_native import NativeTokenServer
    from sentinel_tpu_torch.cluster.token_service import (
        ClusterFlowRule,
        DefaultTokenService,
    )
    from sentinel_tpu_torch.engine import EngineConfig
    from sentinel_tpu_torch.metrics.server import (
        reset_server_metrics_for_tests,
    )

    reset_server_metrics_for_tests()
    cls = NativeTokenServer if door == "native" else TokenServer
    svc = DefaultTokenService(
        EngineConfig(max_flows=16, max_namespaces=4, batch_size=64),
        device="cpu")
    svc.load_rules([ClusterFlowRule(7, 5.0, namespace="ns-door")])
    server = cls(svc, port=0, metrics_port=0, idle_ttl_s=None)
    server.start()
    client = None
    try:
        assert server.metrics_port and server.metrics_port != server.port
        assert server.tuning_kwargs()["metrics_port"] == server.metrics_port
        client = TokenClient("127.0.0.1", server.port, timeout_ms=10_000)
        oks = sum(1 for _ in range(8) if client.request_token(7).ok)
        assert oks == 5
        ctype, body = _scrape(server.metrics_port)
        assert "version=0.0.4" in ctype and body.endswith("\n")
        assert ('sentinel_server_verdicts_total{verdict="pass",'
                f'namespace="ns-door"}} {oks}') in body
        assert "sentinel_build_info{" in body
        port = server.metrics_port
        moved = cls(svc, port=0, **server.tuning_kwargs())
        server.stop()
        moved.start()
        server = moved
        assert server.metrics_port == port
        _, again = _scrape(port)
        assert "sentinel_server_verdicts_total" in again
    finally:
        if client is not None:
            client.close()
        server.stop()
    with pytest.raises(OSError):
        _scrape(port)
