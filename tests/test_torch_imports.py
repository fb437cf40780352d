"""The port imports neither JAX nor the JAX package: a fresh interpreter
imports every ``sentinel_tpu_torch`` module, then ``jax`` and
``sentinel_tpu`` must be absent from ``sys.modules``; also after the native
door's library is built and loaded, and a door has served a frame; after
a standby door has applied a REPL snapshot and been promoted; and after a
door has served a namespace move (MOVE_BEGIN, MOVE_STATE, MOVE_COMMIT from
the port's ``MoveCoordinator``); and after the asyncio door has served the
token client's frames and a share agent's hierarchy frames; and after the
local engine built its native window and ran ``entry`` against an embedded
service and a ``FailoverTokenClient`` walked a dead endpoint to a port door;
and after the Envoy RLS service answered a request through the native
codec and a ``RoutingTokenClient`` followed a namespace MOVE between two
port doors. The adapters and the data sources import with JAX, the JAX
package and every optional framework blocked, and the gRPC interceptors
then raise ``ImportError``. The operator's surface (``init_default``'s
command center, ``setClusterMode`` promoting a native door with a
``metrics_port``, a scrape of both exporters, the metric log, a
``ClusterStateManager`` demotion) serves with neither loaded. So do the
flow mesh (a service on four CPU shards answering a pull) and the dashboard
(a heartbeat registering a machine, a rule pushed through ``v1/rule``).
The subprocesses write their stat logs into the test's temporary
directory."""

import os
import pkgutil
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    import sentinel_tpu_torch

    names = ["sentinel_tpu_torch"]
    for info in pkgutil.walk_packages(sentinel_tpu_torch.__path__,
                                      "sentinel_tpu_torch."):
        names.append(info.name)
    return names


# the adapters and the data sources (ROADMAP items 16 and 15)
ADAPTERS = ("adapters", "adapters.decorator", "adapters.origin",
            "adapters.wsgi", "adapters.asgi", "adapters.gateway_api",
            "adapters.gateway", "adapters.http_client",
            "adapters.grpc_interceptor", "adapters.aiohttp_middleware",
            "adapters.tornado_handler")
# the operator's surface (ROADMAP items 8 and 14)
OPERATOR = ("core.httpd", "metrics", "metrics.exporter", "metrics.log",
            "transport", "transport.command", "transport.command_asgi",
            "transport.handlers", "transport.heartbeat", "cluster.assign",
            "ha.manager", "init")
# the mesh and the dashboard (ROADMAP items 7 and 17)
MESH_AND_DASHBOARD = ("parallel", "parallel.sharding", "dashboard",
                      "dashboard.discovery", "dashboard.repository",
                      "dashboard.rules_repo", "dashboard.validation",
                      "dashboard.api_client", "dashboard.fetcher",
                      "dashboard.dynamic_rules", "dashboard.server")
DATASOURCES = ("datasource", "datasource.base", "datasource.file",
               "datasource.http_util", "datasource.push_base",
               "datasource.converters", "datasource.consul",
               "datasource.etcd", "datasource.nacos", "datasource.apollo",
               "datasource.eureka", "datasource.spring_cloud_config",
               "datasource.redis", "datasource.zookeeper")
# what the card's machine lacks: the optional frameworks, and JAX
BLOCKED = ("jax", "sentinel_tpu", "grpc", "aiohttp", "tornado", "httpx",
           "requests")


def _env(tmp_path):
    return {**os.environ, "CSP_SENTINEL_LOG_DIR": str(tmp_path)}


def test_port_modules_import_without_jax(tmp_path):
    names = _modules()
    for mod in ("ops.decide_cuda", "ops.cms_cuda", "ops.salsa_cuda",
                "ops.prefix_cuda", "engine.param", "engine.outcome",
                "sketch", "sketch.salsa", "sketch.slim", "cluster.concurrent",
                "cluster.token_service", "chaos", "core.config", "core.log",
                "cluster.protocol", "cluster.connection", "cluster.push",
                "cluster.server_native", "metrics.histogram", "metrics.ha",
                "metrics.timeline", "metrics.server", "metrics.profiler",
                "trace.ring", "trace.spans", "trace.slo", "trace.blackbox",
                "overload", "overload.admission", "native.build",
                "native.lib", "ha", "ha.snapshot", "ha.replication",
                "core.property", "metrics.stat_logger", "cluster.rebalance",
                "cluster.hierarchy", "cluster.server", "cluster.client",
                "cluster.shm_client", "core.hashing", "core.registry",
                "metrics.extension", "local", "local.base", "local.stat",
                "local.context", "local.chain", "local.sph", "local.flow",
                "local.degrade", "local.authority", "local.system_adaptive",
                "local.param", "cluster.api", "ha.endpoints", "ha.fallback",
                "ha.failover", "stats.events", "sketch.parity",
                "cluster.namespaces", "cluster.routing",
                "cluster.envoy_rls") + ADAPTERS + DATASOURCES + OPERATOR \
            + MESH_AND_DASHBOARD:
        assert f"sentinel_tpu_torch.{mod}" in names, mod
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'sentinel_tpu' or "
        "m.startswith('sentinel_tpu.'))\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n"
    )
    # -I: no user site or PYTHON* variables, so nothing preloads JAX
    out = subprocess.run(
        [sys.executable, "-I", "-c", code], capture_output=True, text=True,
        timeout=120, cwd=REPO, env=_env(tmp_path),
    )
    assert out.returncode == 0, out.stderr[-2000:]


_SERVE_ONE_FRAME = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
from sentinel_tpu_torch.cluster import protocol as P
from sentinel_tpu_torch.cluster.server_native import NativeTokenServer
from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
from sentinel_tpu_torch.engine import ClusterFlowRule, EngineConfig
from sentinel_tpu_torch.native import lib
lib.load()
svc = DefaultTokenService(EngineConfig(max_flows=8, max_namespaces=2,
                                       batch_size=64), device="cpu")
svc.load_rules([ClusterFlowRule(1, 3.0)])
server = NativeTokenServer(svc, port=0, idle_ttl_s=None)
server.start()
try:
    import socket
    s = socket.create_connection(("127.0.0.1", server.port), timeout=30)
    s.sendall(P.encode_batch_request(7, np.full(5, 1, np.int64)))
    frames, reader = [], P.FrameReader()
    while not frames:
        frames = reader.feed(s.recv(4096))
    xid, st, _r, _w = P.decode_batch_response(frames[0])
    assert xid == 7 and st.tolist() == [0, 0, 0, 1, 1], st
    s.close()
finally:
    server.stop()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "sentinel_tpu" or m.startswith("sentinel_tpu."))
assert not bad, bad
"""


def test_native_door_serves_without_jax(tmp_path):
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler on PATH to build the native door")
    out = subprocess.run(
        [sys.executable, "-I", "-c", _SERVE_ONE_FRAME.format(repo=REPO)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=_env(tmp_path),
    )
    assert out.returncode == 0, out.stderr[-2000:]


_STANDBY_PROMOTES = """
import socket, sys
sys.path.insert(0, {repo!r})
import numpy as np
from sentinel_tpu_torch.cluster import protocol as P
from sentinel_tpu_torch.cluster.server_native import NativeTokenServer
from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
from sentinel_tpu_torch.engine import ClusterFlowRule, EngineConfig
from sentinel_tpu_torch.ha.replication import encode_snapshot_blob
cfg = EngineConfig(max_flows=8, max_namespaces=2, batch_size=64)
primary = DefaultTokenService(cfg, device="cpu")
primary.load_rules([ClusterFlowRule(1, 3.0)])
primary.request_batch_arrays(np.full(2, 1, np.int64))
blob = encode_snapshot_blob(primary.export_state())
server = NativeTokenServer(DefaultTokenService(cfg, device="cpu"), port=0,
                           idle_ttl_s=None, standby_of="primary")
server.start()
try:
    s = socket.create_connection(("127.0.0.1", server.port), timeout=30)
    reader = P.FrameReader()

    pending = []

    def recv():  # the next reply; push frames (rev 7) set aside
        while True:
            while pending:
                payload = pending.pop(0)
                if P.peek_type(payload) not in P.PUSH_TYPES:
                    return payload
            pending.extend(reader.feed(s.recv(1 << 16)))

    for frame in P.encode_repl_blob(3, P.MsgType.REPL_SNAPSHOT, 1, 1, blob):
        s.sendall(frame)
    _xid, code, _gen, seq = P.decode_repl_ack(recv())
    assert (code, seq) == (P.ReplAck.OK, 1), code
    s.sendall(P.encode_batch_request(7, np.full(3, 1, np.int64)))
    assert P.decode_batch_response(recv())[1].tolist() == [9, 9, 9]
    assert server.promote("test") and not server.is_standby
    s.sendall(P.encode_batch_request(8, np.full(3, 1, np.int64)))
    # the snapshot carried two of the flow's three passes
    assert P.decode_batch_response(recv())[1].tolist() == [0, 1, 1]
    s.close()
finally:
    server.stop()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "sentinel_tpu" or m.startswith("sentinel_tpu."))
assert not bad, bad
"""


def test_standby_door_applies_and_promotes_without_jax(tmp_path):
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler on PATH to build the native door")
    out = subprocess.run(
        [sys.executable, "-I", "-c", _STANDBY_PROMOTES.format(repo=REPO)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=_env(tmp_path),
    )
    assert out.returncode == 0, out.stderr[-2000:]


_SERVES_A_MOVE = """
import socket, sys
sys.path.insert(0, {repo!r})
import numpy as np
from sentinel_tpu_torch.cluster import protocol as P
from sentinel_tpu_torch.cluster.rebalance import MoveCoordinator
from sentinel_tpu_torch.cluster.server_native import NativeTokenServer
from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
from sentinel_tpu_torch.engine import ClusterFlowRule, EngineConfig
cfg = EngineConfig(max_flows=8, max_namespaces=2, batch_size=64)
src = DefaultTokenService(cfg, device="cpu")
src.load_rules([ClusterFlowRule(1, 3.0, namespace="m")])
src.request_batch_arrays(np.full(2, 1, np.int64))
dst = DefaultTokenService(cfg, device="cpu")
server = NativeTokenServer(dst, port=0, idle_ttl_s=None)
server.start()
try:
    s = socket.create_connection(("127.0.0.1", server.port), timeout=30)
    s.sendall(P.encode_move_ctrl(5, P.MsgType.MOVE_BEGIN, 1, "x", "peer"))
    xid, code, _gen, _seq = P.decode_repl_ack(P.FrameReader().feed(
        s.recv(4096))[0])
    assert (xid, code) == (5, P.ReplAck.OK), code
    s.close()
    coord = MoveCoordinator(src, self_endpoint="src:1")
    assert coord.move_namespace("m", "127.0.0.1:%d" % server.port,
                                epoch=2), coord.last_error
    assert src.request_batch_arrays(np.full(1, 1, np.int64))[0].tolist() \
        == [10]
    # the flow's window came along: one more pass, then blocks
    assert dst.request_batch_arrays(np.full(2, 1, np.int64))[0].tolist() \
        == [0, 1]
finally:
    server.stop()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "sentinel_tpu" or m.startswith("sentinel_tpu."))
assert not bad, bad
"""


def test_door_serves_a_move_without_jax(tmp_path):
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler on PATH to build the native door")
    out = subprocess.run(
        [sys.executable, "-I", "-c", _SERVES_A_MOVE.format(repo=REPO)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=_env(tmp_path),
    )
    assert out.returncode == 0, out.stderr[-2000:]


def _port_sources():
    """The port's Python sources (its build outputs aside), the smoke
    script and the workloads the smoke imports."""
    root = os.path.join(REPO, "sentinel_tpu_torch")
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "build"]
        yield from (os.path.join(dirpath, f) for f in files
                    if f.endswith(".py"))
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "tests", "torch_kernel_check.py")
    yield os.path.join(REPO, "tests", "torch_param_check.py")
    yield os.path.join(REPO, "tests", "torch_outcome_check.py")
    yield os.path.join(REPO, "tests", "torch_door_check.py")
    yield os.path.join(REPO, "tests", "torch_repl_check.py")
    yield os.path.join(REPO, "tests", "torch_sdk_check.py")
    yield os.path.join(REPO, "tests", "torch_rls_check.py")
    yield os.path.join(REPO, "tests", "torch_adapter_check.py")


def test_port_sources_never_name_jax():
    for f in _port_sources():
        with open(f) as fh:
            for line in fh:
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    mod = s.split()[1]
                    assert not mod.startswith(("jax", "sentinel_tpu.")), (
                        f, s)
                    assert mod != "sentinel_tpu", (f, s)


_ASYNCIO_DOOR_SERVES = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
from sentinel_tpu_torch.cluster.client import TokenClient
from sentinel_tpu_torch.cluster.hierarchy import (
    GlobalBudgetCoordinator, GlobalFlowBudget, PodShareAgent,
)
from sentinel_tpu_torch.cluster.server import TokenServer
from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
from sentinel_tpu_torch.engine import ClusterFlowRule, EngineConfig
svc = DefaultTokenService(EngineConfig(max_flows=8, max_namespaces=2,
                                       batch_size=64), device="cpu")
svc.load_rules([ClusterFlowRule(1, 3.0)])
svc.attach_hierarchy(GlobalBudgetCoordinator([GlobalFlowBudget(1, 3.0)]))
server = TokenServer(svc, port=0, idle_ttl_s=None)
server.start()


class One:
    def __init__(self, endpoints, timeout_ms, deadline_ms):
        self.c = TokenClient(*endpoints[0], timeout_ms=10_000)

    def share_op(self, *a, **k):
        return self.c.share_op(*a, **k)

    def demand_report(self, *a):
        return self.c.demand_report(*a)

    def close(self):
        self.c.close()


try:
    client = TokenClient("127.0.0.1", server.port, timeout_ms=10_000)
    st = client.request_batch_arrays(np.full(5, 1, np.int64))[0]
    assert st.tolist() == [0, 0, 0, 1, 1], st
    agent = PodShareAgent(svc, ["127.0.0.1:%d" % server.port], "pod-a", [1],
                          client_cls=One)
    agent.tick()
    assert agent.shares() == {{1: 3}}, agent.shares()
    agent.close()
    client.close()
finally:
    server.stop()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "sentinel_tpu" or m.startswith("sentinel_tpu."))
assert not bad, bad
"""


def test_asyncio_door_and_clients_serve_without_jax(tmp_path):
    out = subprocess.run(
        [sys.executable, "-I", "-c", _ASYNCIO_DOOR_SERVES.format(repo=REPO)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=_env(tmp_path),
    )
    assert out.returncode == 0, out.stderr[-2000:]


_SDK_SERVES = """
import importlib, socket, sys
sys.path.insert(0, {repo!r})
import sentinel_tpu_torch.local as sentinel
from sentinel_tpu_torch import ha
from sentinel_tpu_torch.cluster import api as cluster_api
from sentinel_tpu_torch.cluster.server_native import NativeTokenServer
from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
from sentinel_tpu_torch.engine import ClusterFlowRule, EngineConfig
from sentinel_tpu_torch.local import stat
from sentinel_tpu_torch.native.lib import NativeWindow

assert stat._NATIVE
assert ha.ClusterStateManager.__module__ == "sentinel_tpu_torch.ha.manager"
svc = DefaultTokenService(EngineConfig(max_flows=8, max_namespaces=2,
                                       batch_size=64), device="cpu")
svc.load_rules([ClusterFlowRule(1, 2.0)])
cluster_api.set_embedded_server(svc)
sentinel.FlowRuleManager.load_rules([sentinel.FlowRule(
    resource="api", count=100.0, cluster_mode=True,
    cluster_config={{"flow_id": 1}})])
verdicts = []
for _ in range(3):
    try:
        with sentinel.entry("api"):
            verdicts.append(True)
    except sentinel.BlockException:
        verdicts.append(False)
assert verdicts == [True, True, False], verdicts
node = sentinel.chain.get_cluster_node("api")
assert isinstance(node.sec, NativeWindow), type(node.sec)
cluster_api.reset_for_tests()

dead = socket.socket()
dead.bind(("127.0.0.1", 0))
dead_port = dead.getsockname()[1]
dead.close()
server = NativeTokenServer(svc, port=0, idle_ttl_s=None)
server.start()
try:
    fc = ha.FailoverTokenClient([("127.0.0.1", dead_port),
                                 ("127.0.0.1", server.port)],
                                timeout_ms=10_000, failure_threshold=1)
    r = fc.request_token(1)
    assert r.status == 1 and fc.active_endpoint.port == server.port, r
    fc.close()
finally:
    server.stop()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "sentinel_tpu" or m.startswith("sentinel_tpu."))
assert not bad, bad
"""


def test_sdk_entry_and_failover_client_without_jax(tmp_path):
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler on PATH to build the native library")
    out = subprocess.run(
        [sys.executable, "-I", "-c", _SDK_SERVES.format(repo=REPO)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=_env(tmp_path),
    )
    assert out.returncode == 0, out.stderr[-2000:]


_CONTROL_PLANE_SERVES = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
from sentinel_tpu_torch.cluster import envoy_rls as R
from sentinel_tpu_torch.cluster import protocol as P
from sentinel_tpu_torch.cluster.rebalance import (
    MoveCoordinator, ShardMapPublisher,
)
from sentinel_tpu_torch.cluster.routing import RoutingTokenClient
from sentinel_tpu_torch.cluster.server_native import NativeTokenServer
from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
from sentinel_tpu_torch.engine import ClusterFlowRule, EngineConfig
cfg = EngineConfig(max_flows=8, max_namespaces=2, batch_size=64)
svc = DefaultTokenService(cfg, device="cpu")
rules = R.EnvoyRlsRuleManager(svc)
rules.load_rules([R.EnvoyRlsRule("d", (R.RlsDescriptor((("k", "v"),), 1),))])
rls = R.RlsService(svc, rules)
req = R.encode_rate_limit_request("d", [[("k", "v")]])
codes = [R.decode_rate_limit_response(R.encode_rate_limit_response(
    rls.should_rate_limit(*R.decode_rate_limit_request(req)))).overall_code
    for _ in range(2)]
assert codes == [R.CODE_OK, R.CODE_OVER_LIMIT], codes
payload = P.encode_batch_request(4, np.arange(3, dtype=np.int64))[2:]
assert P.decode_batch_request(payload)[1].tolist() == [0, 1, 2]
assert P._NATIVE is not None

src = DefaultTokenService(cfg, device="cpu")
src.load_rules([ClusterFlowRule(1, 3.0, namespace="m")])
dst = DefaultTokenService(cfg, device="cpu")
doors = [NativeTokenServer(s, port=0, idle_ttl_s=None) for s in (src, dst)]
for d in doors:
    d.start()
try:
    eps = ["127.0.0.1:%d" % d.port for d in doors]
    pub = ShardMapPublisher()
    rc = RoutingTokenClient(
        timeout_ms=10_000, namespace_of={{1: "m"}}, pod_of={{"m": eps[0]}},
        endpoints={{e: ("127.0.0.1", int(e.split(":")[1])) for e in eps}},
        shard_maps=pub)
    assert rc.request_token(1).ok
    assert MoveCoordinator(src, self_endpoint=eps[0],
                           publisher=pub).move_namespace("m", eps[1])
    # the router follows the published map to the destination
    assert rc.epoch == 1 and rc.request_token(1).ok
    assert rc._state.pod_of["m"] == eps[1]
    # the window came along: the count of 3 holds across the move
    assert [int(rc.request_token(1).status) for _ in range(2)] == [0, 1]
    rc.close()
finally:
    for d in doors:
        d.stop()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "sentinel_tpu" or m.startswith("sentinel_tpu."))
assert not bad, bad
"""


def test_rls_and_routing_client_serve_without_jax(tmp_path):
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler on PATH to build the native library")
    out = subprocess.run(
        [sys.executable, "-I", "-c",
         _CONTROL_PLANE_SERVES.format(repo=REPO)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=_env(tmp_path),
    )
    assert out.returncode == 0, out.stderr[-2000:]


_WITHOUT_FRAMEWORKS = """
import importlib, sys
sys.path.insert(0, {repo!r})
for name in {blocked!r}:
    sys.modules[name] = None  # an import of it raises ImportError
for name in ("sentinel_tpu_torch.adapters", "sentinel_tpu_torch.datasource"):
    importlib.import_module(name)
for name in {lazy!r}:
    importlib.import_module("sentinel_tpu_torch." + name)
try:
    importlib.import_module("sentinel_tpu_torch.adapters.grpc_interceptor")
except ImportError:
    pass
else:
    raise AssertionError("the gRPC interceptors imported without grpc")
from sentinel_tpu_torch.adapters import sentinel_resource
from sentinel_tpu_torch.datasource.converters import (
    cluster_flow_rules_from_json, gateway_flow_rules_from_json,
)
assert sentinel_resource("r")(lambda: 7)() == 7
assert cluster_flow_rules_from_json('[{{"flowId": 3, "count": 2}}]')[0].flow_id == 3
assert gateway_flow_rules_from_json('[{{"resource": "g"}}]')[0].resource == "g"
bad = sorted(m for m in sys.modules if sys.modules[m] is not None and (
    m.split(".")[0] in {blocked!r}))
assert not bad, bad
"""


def test_adapters_and_datasources_import_without_frameworks(tmp_path):
    lazy = [m for m in ADAPTERS + DATASOURCES
            if m != "adapters.grpc_interceptor"]
    code = _WITHOUT_FRAMEWORKS.format(repo=REPO, blocked=BLOCKED, lazy=lazy)
    out = subprocess.run(
        [sys.executable, "-I", "-c", code], capture_output=True, text=True,
        timeout=300, cwd=REPO, env=_env(tmp_path),
    )
    assert out.returncode == 0, out.stderr[-2000:]


_OPERATOR_SERVES = """
import json, sys, urllib.request
sys.path.insert(0, {repo!r})
import sentinel_tpu_torch
from sentinel_tpu_torch import init
from sentinel_tpu_torch.cluster import api as cluster_api
from sentinel_tpu_torch.cluster.server_native import NativeTokenServer
from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
from sentinel_tpu_torch.core.config import SentinelConfig
from sentinel_tpu_torch.engine import ClusterFlowRule, EngineConfig
from sentinel_tpu_torch.ha import ClusterStateManager
from sentinel_tpu_torch.metrics.log import MetricTimer, MetricWriter
from sentinel_tpu_torch.transport import handlers as H

assert sentinel_tpu_torch.__version__ == "0.1.0"
cfg = EngineConfig(max_flows=8, max_namespaces=2, batch_size=64)
def factory(cls, host, port):
    return cls(DefaultTokenService(cfg, device="cpu"), host=host, port=port,
               metrics_port=0, idle_ttl_s=None)
SentinelConfig.set("csp.sentinel.cluster.server.native", "true")
rt = init.init_default(command_port=0, server_factory=factory,
                       with_metric_log=False)
base = "http://127.0.0.1:%d/" % rt.command_center.port
def get(path):
    with urllib.request.urlopen(base + path, timeout=120) as r:
        return r.read().decode()
try:
    assert get("setClusterMode?mode=1&tokenPort=0") == "success"
    door = H._EMBEDDED_SERVER["server"]
    assert isinstance(door, NativeTokenServer) and door.metrics_port
    svc = cluster_api.get_embedded_server()
    svc.load_rules([ClusterFlowRule(1, 2.0)])
    assert [svc.request_token(1).ok for _ in range(3)] == [True, True, False]
    body = get("metric/prometheus")
    assert 'torch_backend="cpu"' in body, body[-400:]
    with urllib.request.urlopen(
            "http://127.0.0.1:%d/metrics" % door.metrics_port) as r:
        assert "sentinel_server_verdicts_total" in r.read().decode()
    assert json.loads(get("cluster/server/metrics"))["1"]
    timer = MetricTimer(MetricWriter(base_dir={tmp!r}))
    timer.writer.write(timer.collect_once())
    timer.writer.close()
    ClusterStateManager(factory).to_off()
    assert cluster_api.get_embedded_server() is None
finally:
    init.shutdown()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "sentinel_tpu" or m.startswith("sentinel_tpu."))
assert not bad, bad
"""


def test_operator_surface_serves_without_jax(tmp_path):
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler on PATH to build the native library")
    code = _OPERATOR_SERVES.format(repo=REPO, tmp=str(tmp_path / "metrics"))
    out = subprocess.run(
        [sys.executable, "-I", "-c", code], capture_output=True, text=True,
        timeout=300, cwd=REPO, env=_env(tmp_path),
    )
    assert out.returncode == 0, out.stderr[-2000:]


_MESH_AND_DASHBOARD_SERVE = """
import json, sys, urllib.request
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
from sentinel_tpu_torch.dashboard import DashboardServer
from sentinel_tpu_torch.engine import ClusterFlowRule, EngineConfig
from sentinel_tpu_torch.local import FlowRuleManager
from sentinel_tpu_torch.parallel import make_flow_mesh
from sentinel_tpu_torch.transport.command import CommandCenter
from sentinel_tpu_torch.transport.heartbeat import HeartbeatSender

mesh = make_flow_mesh([torch.device("cpu")] * 4)
svc = DefaultTokenService(EngineConfig(max_flows=16, max_namespaces=2,
                                       batch_size=64), mesh=mesh)
svc.load_rules([ClusterFlowRule(f, 2.0) for f in range(8)])
st, _r, _w = svc.request_batch_arrays(np.asarray([1, 1, 1, 6, 99]))
assert st.tolist() == [0, 0, 1, 0, 3], st
dash = DashboardServer(port=0).start()
cc = CommandCenter(port=0).start()
try:
    assert HeartbeatSender(["127.0.0.1:%d" % dash.port],
                           command_port=cc.port,
                           client_ip="127.0.0.1").send_once()
    req = urllib.request.Request(
        "http://127.0.0.1:%d/v1/rule?app=sentinel-tpu-app&type=flow"
        % dash.port, data=json.dumps({{"resource": "r", "count": 3}}).encode(),
        method="POST")
    with urllib.request.urlopen(req, timeout=30) as rsp:
        assert json.loads(rsp.read())["pushed"] == 1
    assert [r.count for r in FlowRuleManager.get_rules("r")] == [3.0]
finally:
    cc.stop()
    dash.stop()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "sentinel_tpu" or m.startswith("sentinel_tpu."))
assert not bad, bad
"""


def test_mesh_and_dashboard_serve_without_jax(tmp_path):
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler on PATH to build the native library")
    code = _MESH_AND_DASHBOARD_SERVE.format(repo=REPO)
    out = subprocess.run(
        [sys.executable, "-I", "-c", code], capture_output=True, text=True,
        timeout=300, cwd=REPO, env=_env(tmp_path),
    )
    assert out.returncode == 0, out.stderr[-2000:]
