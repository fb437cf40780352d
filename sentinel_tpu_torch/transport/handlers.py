"""Default command handlers (the port's copy of
``sentinel_tpu/transport/handlers.py``).

Analogs of the handler set in ``sentinel-transport-common/.../command/handler``
(``version``, ``basicInfo``, ``getRules``/``setRules``
(``FetchActiveRuleCommandHandler.java:31`` / ``ModifyRulesCommandHandler.java:
46``), ``metric`` (``SendMetricCommandHandler.java:41``), ``clusterNode``,
``tree``, ``systemStatus``, ``setClusterMode``/``getClusterMode`` and the
cluster-server metric fetch).

Where the reference falls back or probes, the port does not:

- ``csp.sentinel.cluster.server.native=true`` serves through
  ``NativeTokenServer``, whose construction builds the native library and
  raises if it cannot (the reference quietly serves through the asyncio
  door);
- ``setClusterMode`` mode 1 builds ``DefaultTokenService()`` on the card,
  unless the caller passed a ``server_factory`` (``CommandCenter``,
  ``init_default``, ``apply_cluster_mode``, ``cluster.assign`` and
  ``ClusterStateManager`` take one): ``server_factory(server_cls, host,
  port)`` returns the door, not started, that mode 1 runs. It is how a test
  asks for a CPU service and how a caller gives the door a
  ``metrics_port``;
- the doors and the service are read through their own attributes, with
  no ``getattr`` / ``hasattr`` probe; where a token client stands in the
  service's place (``cluster/server/metrics`` in client mode) the answer is
  the reference's ``{}``, by an ``isinstance`` test.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

import sentinel_tpu_torch
from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.core.config import SentinelConfig
from sentinel_tpu_torch.datasource import converters as conv
from sentinel_tpu_torch.datasource.base import WritableDataSourceRegistry
from sentinel_tpu_torch.local.authority import AuthorityRuleManager
from sentinel_tpu_torch.local.degrade import DegradeRuleManager
from sentinel_tpu_torch.local.flow import FlowRuleManager
from sentinel_tpu_torch.local.param import ParamFlowRuleManager
from sentinel_tpu_torch.local.system_adaptive import SystemRuleManager
from sentinel_tpu_torch.transport.command import ServerFactory, command_mapping

# rule type → (serialize current rules to json, parse json, load parsed rules)
_RULE_TYPES = {
    "flow": (
        lambda: conv.flow_rules_to_json(FlowRuleManager.all_rules()),
        conv.flow_rules_from_json,
        FlowRuleManager.load_rules,
    ),
    "degrade": (
        lambda: conv.degrade_rules_to_json(
            [cb.rule for lst in DegradeRuleManager._breakers.values() for cb in lst]
        ),
        conv.degrade_rules_from_json,
        DegradeRuleManager.load_rules,
    ),
    "system": (
        lambda: conv.system_rules_to_json(
            [SystemRuleManager._effective] if SystemRuleManager._any_enabled else []
        ),
        conv.system_rules_from_json,
        SystemRuleManager.load_rules,
    ),
    "authority": (
        lambda: conv.authority_rules_to_json(
            [r for lst in AuthorityRuleManager._rules.values() for r in lst]
        ),
        conv.authority_rules_from_json,
        AuthorityRuleManager.load_rules,
    ),
    "paramFlow": (
        lambda: conv.param_flow_rules_to_json(
            [r for lst in ParamFlowRuleManager.all_rules().values() for r in lst]
        ),
        conv.param_flow_rules_from_json,
        ParamFlowRuleManager.load_rules,
    ),
    "gateway": (
        lambda: conv.gateway_flow_rules_to_json(_gateway_rules()),
        conv.gateway_flow_rules_from_json,
        lambda rules: _gateway_manager().load_rules(rules),
    ),
}


def _gateway_manager():
    from sentinel_tpu_torch.adapters.gateway import GatewayRuleManager

    return GatewayRuleManager


def _gateway_rules():
    return [
        r for lst in _gateway_manager()._rules.values() for r in lst
    ]


@command_mapping("version", "framework version")
def cmd_version(params, body):
    return f"sentinel-tpu/{sentinel_tpu_torch.__version__}"


@command_mapping("basicInfo", "machine basic info")
def cmd_basic_info(params, body):
    import socket

    return {
        "appName": SentinelConfig.app_name(),
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
        "version": sentinel_tpu_torch.__version__,
        "currentTime": _clock.now_ms(),
    }


@command_mapping("getRules", "get active rules; type=flow|degrade|system|authority|paramFlow|gateway")
def cmd_get_rules(params, body):
    rtype = params.get("type", "flow")
    if rtype not in _RULE_TYPES:
        return {"error": f"unknown rule type {rtype}"}
    return json.loads(_RULE_TYPES[rtype][0]())


@command_mapping("setRules", "replace rules; type=... body/data=json array")
def cmd_set_rules(params, body):
    rtype = params.get("type", "flow")
    if rtype not in _RULE_TYPES:
        return {"error": f"unknown rule type {rtype}"}
    data = body or params.get("data", "[]")
    _, parse, load = _RULE_TYPES[rtype]
    rules = parse(data)
    load(rules)
    # write-through to a registered writable datasource, passing the parsed,
    # normalized rules — the serializer contract takes rule objects
    # (ModifyRulesCommandHandler.java:58)
    WritableDataSourceRegistry.write_if_registered(rtype, rules)
    return "success"


@command_mapping("gateway/getApiDefinitions", "custom gateway API groups")
def cmd_gateway_get_api_definitions(params, body):
    """``GetGatewayApiDefinitionsCommandHandler`` analog."""
    from sentinel_tpu_torch.adapters.gateway_api import (
        GatewayApiDefinitionManager,
        api_definition_to_dict,
    )

    return [
        api_definition_to_dict(d)
        for d in GatewayApiDefinitionManager.get_api_definitions()
    ]


@command_mapping(
    "gateway/updateApiDefinitions",
    "replace gateway API groups; body/data=json array",
)
def cmd_gateway_update_api_definitions(params, body):
    """``UpdateGatewayApiDefinitionGroupCommandHandler`` analog."""
    from sentinel_tpu_torch.adapters.gateway_api import (
        GatewayApiDefinitionManager,
        parse_api_definition,
    )

    data = body or params.get("data", "[]")
    definitions = [parse_api_definition(obj) for obj in json.loads(data)]
    GatewayApiDefinitionManager.load_api_definitions(definitions)
    return "success"


@command_mapping("metric", "metric log lines; startTime&endTime[&identity]")
def cmd_metric(params, body):
    from sentinel_tpu_torch.metrics.log import MetricSearcher, default_metric_dir

    begin = int(params.get("startTime", 0))
    end = int(params.get("endTime", 2**62))
    identity = params.get("identity")
    searcher = MetricSearcher(default_metric_dir(), SentinelConfig.app_name())
    lines = [n.to_line() for n in searcher.find(begin, end, identity)]
    return "\n".join(lines)


@command_mapping("metric/prometheus", "Prometheus text exposition of live stats")
def cmd_metric_prometheus(params, body):
    from sentinel_tpu_torch.metrics.exporter import CONTENT_TYPE, render

    return (200, render(), CONTENT_TYPE)  # text format, not JSON


@command_mapping("clusterNode", "per-resource statistics snapshot")
def cmd_cluster_node(params, body):
    from sentinel_tpu_torch.local.chain import cluster_node_map

    now = _clock.now_ms()
    out = []
    for name, cn in cluster_node_map().items():
        out.append(
            {
                "resourceName": name,
                "passQps": cn.pass_qps(now),
                "blockQps": cn.block_qps(now),
                "totalQps": cn.total_qps(now),
                "averageRt": cn.avg_rt(now),
                "exceptionQps": cn.exception_qps(now),
                "threadNum": cn.cur_thread_num,
                "oneMinutePass": cn.total_pass_minute(now),
            }
        )
    return out


@command_mapping("origin", "per-origin statistics for a resource; id=<resource>")
def cmd_origin(params, body):
    from sentinel_tpu_torch.local.chain import get_cluster_node

    cn = get_cluster_node(params.get("id", ""))
    if cn is None:
        return []
    now = _clock.now_ms()
    return [
        {
            "origin": origin,
            "passQps": node.pass_qps(now),
            "blockQps": node.block_qps(now),
            "averageRt": node.avg_rt(now),
            "threadNum": node.cur_thread_num,
        }
        for origin, node in cn.origin_nodes.items()
    ]


@command_mapping("tree", "invocation tree")
def cmd_tree(params, body):
    from sentinel_tpu_torch.local import context as ctx_mod

    def walk(node, depth=0):
        lines = ["  " * depth + node.resource.name]
        for child in node.children:
            lines.extend(walk(child, depth + 1))
        return lines

    return "\n".join(walk(ctx_mod.root()))


@command_mapping("systemStatus", "system-adaptive state")
def cmd_system_status(params, body):
    from sentinel_tpu_torch.local.chain import entry_node

    now = _clock.now_ms()
    en = entry_node()
    return {
        "load": SystemRuleManager.status.current_load(),
        "cpuUsage": SystemRuleManager.status.current_cpu_usage(),
        "inboundQps": en.pass_qps(now),
        "inboundThreads": en.cur_thread_num,
        "avgRt": en.avg_rt(now),
    }


@command_mapping("getClusterMode", "cluster state: -1 off, 0 client, 1 server")
def cmd_get_cluster_mode(params, body):
    from sentinel_tpu_torch.cluster import api as cluster_api

    return {"mode": int(cluster_api.get_mode())}


_EMBEDDED_SERVER = {"server": None}
# Guards the check-create-store sequence below: a retried setClusterMode
# (promotion compiles the decision kernels, so the first call can be slow)
# must not race the in-flight first call and double-start port-bound servers.
_EMBEDDED_LOCK = threading.Lock()


def _server_class():
    """Transport selection: ``csp.sentinel.cluster.server.native=true``
    serves through the native epoll front door (C++ data plane), whose
    construction builds the native library and raises if it cannot; the
    default is the asyncio transport."""
    if SentinelConfig.get_bool("csp.sentinel.cluster.server.native"):
        from sentinel_tpu_torch.cluster.server_native import NativeTokenServer

        return NativeTokenServer
    from sentinel_tpu_torch.cluster.server import TokenServer

    return TokenServer


def _rebind_server_port(prev, new_port: int):
    """Rebuild a running token server on ``new_port``, preserving its class
    (asyncio or native front door), its service (rules + counters), and its
    operator tuning; on failure roll back onto the old port so the fleet
    keeps a token server. Caller holds ``_EMBEDDED_LOCK`` and has cleared
    the registry slot. Returns the running replacement."""
    server_cls = type(prev)
    tuning = prev.tuning_kwargs()
    service = prev.service
    host = prev.host
    old_port = prev.port
    prev.stop()
    try:
        server = server_cls(service, host=host, port=new_port, **tuning)
        server.start()
        return server
    except Exception:
        rollback = server_cls(service, host=host, port=old_port, **tuning)
        rollback.start()
        _EMBEDDED_SERVER["server"] = rollback
        raise


def apply_cluster_mode(
    mode: int,
    token_port: int = 18730,
    server_factory: Optional[ServerFactory] = None,
) -> None:
    """Switch this agent's cluster state. Mode 1 provisions the embedded
    token server (transport + device service) and registers it — the analog
    of ``ModifyClusterModeCommandHandler`` → ``DefaultEmbeddedTokenServer``
    start. Leaving server mode stops it. Idempotent: repeating the current
    mode (e.g. a dashboard retry after a slow first promote) reconciles
    instead of double-starting. Shared by the setClusterMode command and the
    datasource-driven path (``cluster.assign``).

    ``server_factory(server_cls, host, port)`` builds the door that mode 1
    starts; without one it is ``server_cls(DefaultTokenService(), host=host,
    port=port)``, a service on the card."""
    from sentinel_tpu_torch.cluster import api as cluster_api

    with _EMBEDDED_LOCK:
        prev = _EMBEDDED_SERVER["server"]
        if mode == int(cluster_api.ClusterMode.SERVER):
            if prev is not None and token_port not in (0, prev.port):
                # port reconfiguration (e.g. a datasource edit): the running
                # server must move, not silently keep the old port. The
                # service (rules, counters), transport class, and tuning are
                # preserved across the move; failure rolls back.
                _EMBEDDED_SERVER["server"] = None
                _EMBEDDED_SERVER["server"] = _rebind_server_port(
                    prev, token_port
                )
            elif prev is None:
                from sentinel_tpu_torch.cluster.token_service import (
                    DefaultTokenService,
                )

                server_cls = _server_class()
                if server_factory is None:
                    server = server_cls(
                        DefaultTokenService(), host="0.0.0.0", port=token_port
                    )
                else:
                    server = server_factory(server_cls, "0.0.0.0", token_port)
                try:
                    server.start()
                except Exception:
                    server.stop()  # release any half-bound resources
                    raise
                _EMBEDDED_SERVER["server"] = server
            cluster_api.set_embedded_server(_EMBEDDED_SERVER["server"].service)
            return
        if prev is not None:
            _EMBEDDED_SERVER["server"] = None
            prev.stop()
            # the demoted server's service must not keep answering
            # cluster/server/* commands as if this were still a token server
            cluster_api.clear_embedded_server()
        cluster_api.set_mode(cluster_api.ClusterMode(mode))


@command_mapping(
    "setClusterMode", "switch cluster state; mode=-1|0|1 [&tokenPort=18730]"
)
def cmd_set_cluster_mode(params, body):
    from sentinel_tpu_torch.transport.command import SERVER_FACTORY

    apply_cluster_mode(
        int(params.get("mode", -1)), int(params.get("tokenPort", 18730)),
        SERVER_FACTORY.get(),
    )
    return "success"


def apply_client_assignment(data) -> Optional[str]:
    """(Re)install the global token client against an assigned server
    address (``ClusterClientConfigManager`` applying
    ``ClusterClientAssignConfig``). Returns an error string or None. Shared
    by the modifyConfig command and the datasource-driven path
    (``cluster.assign``). Idempotent on identical assignments so a polling
    datasource doesn't churn connections."""
    from sentinel_tpu_torch.cluster import api as cluster_api
    from sentinel_tpu_torch.cluster.client import TokenClient

    host = data.get("serverHost")
    port = int(data.get("serverPort", 0))
    if not host or not port:
        return "serverHost and serverPort required"
    timeout_ms = int(data.get("requestTimeout", 20))
    # the namespace this agent declares in its PING handshake — the server
    # scopes connection counts (AVG_LOCAL scaling) by it
    # (ClusterClientConfigManager's namespace config)
    namespace = str(data.get("namespace", "default") or "default")
    assignment = dict(
        serverHost=host, serverPort=port, requestTimeout=timeout_ms,
        namespace=namespace,
    )
    # idempotent ONLY while actually operating as a client: a repeated
    # assignment after a mode switch (or reset) must reinstall the client
    # and restore CLIENT mode, not silently no-op
    if (
        assignment == _CLUSTER_CLIENT_CONFIG
        and cluster_api.get_mode() == cluster_api.ClusterMode.CLIENT
        and cluster_api._client is not None
    ):
        return None
    cluster_api.set_client(
        TokenClient(host, port, timeout_ms=timeout_ms, namespace=namespace)
    )
    _CLUSTER_CLIENT_CONFIG.clear()
    _CLUSTER_CLIENT_CONFIG.update(assignment)
    return None


@command_mapping(
    "cluster/client/modifyConfig", "point the token client at a server; data={serverHost, serverPort}"
)
def cmd_cluster_client_modify_config(params, body):
    """``ModifyClusterClientConfigHandler`` analog."""
    data = json.loads(body) if body else params
    error = apply_client_assignment(data)
    return {"error": error} if error else "success"


_CLUSTER_CLIENT_CONFIG: dict = {}


@command_mapping("cluster/client/fetchConfig", "current token-client assignment")
def cmd_cluster_client_fetch_config(params, body):
    return dict(_CLUSTER_CLIENT_CONFIG)


@command_mapping(
    "clusterServerStats",
    "token-server pipeline stats: verdict counters, stage histograms, "
    "gauges, param-sketch block",
)
def cmd_cluster_server_stats(params, body):
    """JSON twin of the ``sentinel_server_*`` Prometheus section — the
    dashboard/command-center view of the serving pipeline, plus the HA
    rebalance block (move protocol events, shipped state bytes, redirect
    counts) so the dashboard sees live shard moves next to the pipeline.
    The ``sketch`` block mirrors ``sentinel_sketch_*``: the param sketch's
    variant, fat/slim HBM bytes, and SALSA merge counters per rule slot
    (docs/SKETCHES.md). The ``trace`` block is the flight recorder's
    arming state, the ``slo`` block the per-tenant latency/burn-rate
    plane, and ``buildInfo`` the version/wire-rev stamp — so one stats
    pull carries everything a fleet merge needs
    (docs/OBSERVABILITY.md)."""
    from sentinel_tpu_torch.metrics import exporter
    from sentinel_tpu_torch.metrics.ha import ha_metrics
    from sentinel_tpu_torch.metrics.server import server_metrics
    from sentinel_tpu_torch.trace import ring as trace_ring
    from sentinel_tpu_torch.trace.slo import slo_plane

    from sentinel_tpu_torch.metrics.timeline import timeline

    out = server_metrics().snapshot()
    out["rebalance"] = ha_metrics().snapshot()["rebalance"]
    out["trace"] = trace_ring.status()
    out["slo"] = slo_plane().snapshot()
    out["timeline"] = timeline().status()
    out["buildInfo"] = exporter.build_info()
    return out


@command_mapping(
    "cluster/server/metric",
    "per-namespace per-second timeline; "
    "startTime&endTime[&namespace][&maxLines]",
)
def cmd_cluster_server_metric(params, body):
    """``SendMetricCommandHandler`` parity for the cluster door: the
    local ``metric`` command reads per-resource seconds from the rolled
    metric log; this reads per-namespace seconds from the metric
    timeline (in-memory window merged with the rolled timeline files
    when ``SENTINEL_TIMELINE_DIR`` is configured). Times are epoch ms;
    the response is a JSON list of per-(second, namespace) samples with
    pass/block/shed/other counts and bucketed p99/max decision latency
    — the series the scenario harness gates on (docs/SCENARIOS.md)."""
    from sentinel_tpu_torch.metrics.timeline import timeline

    begin = int(params.get("startTime", 0))
    end_raw = params.get("endTime")
    end = int(end_raw) if end_raw is not None else None
    namespace = params.get("namespace")
    max_lines = int(params.get("maxLines", 12000))
    samples = timeline().find(
        begin, end, namespace=namespace, max_lines=max_lines
    )
    return [s.as_dict() for s in samples]


@command_mapping(
    "cluster/server/profiler",
    "JAX profiler trace control; action=start|stop|status [&dir=/tmp/trace]",
)
def cmd_cluster_server_profiler(params, body):
    """Opt-in device-trace capture on a LIVE server: start writes a
    TensorBoard/XProf trace of every device step until stop. Targets the
    embedded token server's hook when one is running, else the process-wide
    hook (profiles local JAX work)."""
    from sentinel_tpu_torch.metrics.profiler import default_hook

    with _EMBEDDED_LOCK:
        server = _EMBEDDED_SERVER["server"]
    hook = server.profiler if server is not None else default_hook()
    action = params.get("action", "status")
    if action == "start":
        return hook.start(params.get("dir"))
    if action == "stop":
        return hook.stop()
    if action == "status":
        return hook.status()
    return {"error": "action must be start|stop|status"}


@command_mapping(
    "cluster/server/trace",
    "flight-recorder control; action=arm|disarm|status|spans|blackbox "
    "[&sample=0.01][&xid=][&limit=][&dir=]",
)
def cmd_cluster_server_trace(params, body):
    """Operator surface of the always-on flight recorder
    (``sentinel_tpu_torch.trace``, docs/OBSERVABILITY.md):

    - ``arm``/``disarm``: start/stop recording (``sample`` = fraction of
      xids end-to-end sampled; control events always record while armed);
    - ``status``: arming state + per-thread ring occupancy;
    - ``spans``: assemble sampled end-to-end spans on demand — ``xid``
      picks one, otherwise the newest ``limit`` sampled xids, with the
      step spans of the newest ``limit`` steps on the wall clock and the
      clock anchor; ``dir``
      additionally writes the JSON artifact and returns its path;
    - ``blackbox``: force a black-box dump now (``dir`` overrides the
      configured directory) — the same artifact brownout escalation,
      standby promotion, and MOVE aborts write automatically.
    """
    from sentinel_tpu_torch.trace import blackbox, spans
    from sentinel_tpu_torch.trace import ring as trace_ring

    action = params.get("action", "status")
    if action == "arm":
        trace_ring.arm(sample=float(params.get("sample", 0.01)))
        return trace_ring.status()
    if action == "disarm":
        trace_ring.disarm()
        return trace_ring.status()
    if action == "status":
        return trace_ring.status()
    if action == "spans":
        xid = params.get("xid")
        if xid is not None:
            span = spans.assemble(int(xid, 0) if isinstance(xid, str)
                                  else int(xid))
            if span is None:
                return {"error": f"xid {xid} not in the rings "
                        "(unsampled, or overwritten)"}
            return span
        limit = int(params.get("limit", 64))
        out_dir = params.get("dir")
        if out_dir:
            path = os.path.join(
                out_dir, f"trace-spans-{_clock.now_ms()}.json"
            )
            return {"path": spans.write_artifact(path, limit=limit)}
        assembled = spans.assemble_recent(limit=limit)
        return {
            "completeness": spans.completeness(assembled),
            "spans": assembled,
            "clockAnchor": trace_ring.clock_anchor(),
            "stepSpans": trace_ring.spans(wall=True, limit=limit),
        }
    if action == "blackbox":
        if not blackbox.enabled() and not params.get("dir"):
            return {"error": "no black-box dir configured; pass dir="}
        return {
            "path": blackbox.dump(
                reason=params.get("reason", "operator"),
                directory=params.get("dir"),
            )
        }
    return {"error": "action must be arm|disarm|status|spans|blackbox"}


@command_mapping(
    "cluster/server/slo",
    "per-tenant SLO plane; action=local|fleet (fleet: body = JSON list "
    "of pod clusterServerStats/slo payloads)",
)
def cmd_cluster_server_slo(params, body):
    """Per-tenant latency/burn-rate surface (``sentinel_tpu_torch.trace.slo``):

    - ``local``: this pod's snapshot — objective, per-namespace latency
      quantiles, 1m/1h burn rates, shed attribution;
    - ``fleet``: merge pod snapshots into the fleet view. The body is a
      JSON array whose items are either raw ``slo`` snapshots or whole
      ``clusterServerStats`` payloads (their ``slo`` block is used) —
      the same pull-and-merge path ``aggregate_snapshots`` established
      for per-flow metrics. Malformed pod items contribute nothing.
    """
    from sentinel_tpu_torch.trace.slo import merge_fleet, slo_plane

    action = params.get("action", "local")
    if action == "local":
        return slo_plane().snapshot()
    if action == "fleet":
        try:
            pods = json.loads(body) if body else []
        except Exception:
            return {"error": "body must be a JSON array of pod payloads"}
        if not isinstance(pods, list):
            return {"error": "body must be a JSON array of pod payloads"}
        snaps = [
            p.get("slo", p) if isinstance(p, dict) else p for p in pods
        ]
        merged = merge_fleet(snaps)
        merged["pods"] = len(pods)
        return merged
    return {"error": "action must be local|fleet"}


@command_mapping(
    "cluster/server/snapshot",
    "token-server state snapshot; action=save|fetch|restore|status [&dir=]",
)
def cmd_cluster_server_snapshot(params, body):
    """HA state snapshot surface (``sentinel_tpu_torch.ha.snapshot``):

    - ``save``: write an artifact to ``dir`` (or the server's configured
      snapshot directory) and return its path;
    - ``fetch``: return the encoded snapshot document inline — the warm
      standby's pull path (restore it with action=restore, body=doc);
    - ``restore``: load state from the JSON document in the body, or from
      the newest artifact in ``dir``;
    - ``status``: periodic-writer configuration and last artifact path.
    """
    from sentinel_tpu_torch.cluster import api as cluster_api
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.ha import snapshot as ha_snapshot

    service = cluster_api.get_embedded_server()
    if not isinstance(service, DefaultTokenService):
        return {"error": "this machine is not a token server"}
    action = params.get("action", "status")
    if action == "fetch":
        return ha_snapshot.snapshot_to_doc(service)
    if action == "save":
        directory = params.get("dir") or _snapshot_dir_of_embedded()
        if not directory:
            return {"error": "no snapshot dir configured; pass dir="}
        return {"path": ha_snapshot.save_snapshot(service, directory)}
    if action == "restore":
        if body:
            try:
                ha_snapshot.restore_from_doc(service, json.loads(body))
            except ValueError as e:
                return {"error": str(e)}
            return "success"
        directory = params.get("dir") or _snapshot_dir_of_embedded()
        if not directory:
            return {"error": "no snapshot dir configured; pass dir= or body"}
        if not ha_snapshot.restore_latest(service, directory):
            return {"error": f"no usable snapshot in {directory}"}
        return "success"
    if action == "status":
        out = {"dir": _snapshot_dir_of_embedded()}
        with _EMBEDDED_LOCK:
            server = _EMBEDDED_SERVER["server"]
        manager = server._snapshots if server is not None else None
        if manager is not None:
            out["periodS"] = manager.period_s
            out["lastPath"] = manager.last_path
        return out
    return {"error": "action must be save|fetch|restore|status"}


def _snapshot_dir_of_embedded():
    with _EMBEDDED_LOCK:
        server = _EMBEDDED_SERVER["server"]
    return server.snapshot_dir if server is not None else None


@command_mapping(
    "cluster/server/promote",
    "warm-standby control; action=promote|status",
)
def cmd_cluster_server_promote(params, body):
    """Replication role surface (``sentinel_tpu_torch.ha.replication``):

    - ``promote``: open an unpromoted standby's front door (idempotent;
      errors if this server is not a standby);
    - ``status``: replication role + sender/applier progress counters.
    """
    with _EMBEDDED_LOCK:
        server = _EMBEDDED_SERVER["server"]
    if server is None:
        return {"error": "this machine is not a token server"}
    action = params.get("action", "status")
    if action == "promote":
        applier = server.applier
        if applier is None:
            return {"error": "this server is not a standby"}
        already = applier.promoted
        server.promote(reason=params.get("reason", "manual"))
        return {"promoted": True, "alreadyPromoted": already}
    if action == "status":
        out = {"isStandby": server.is_standby}
        applier = server.applier
        if applier is not None:
            out["applier"] = applier.status()
        replicator = server.replicator
        if replicator is not None:
            out["sender"] = replicator.status()
        return out
    return {"error": "action must be promote|status"}


@command_mapping("cluster/server/metrics", "token-server per-flow metrics")
def cmd_cluster_server_metrics(params, body):
    from sentinel_tpu_torch.cluster import api as cluster_api
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService

    service = cluster_api._pick_service()
    if not isinstance(service, DefaultTokenService):
        return {}  # no service, or a token client in its place
    return {str(k): v for k, v in service.metrics_snapshot().items()}


# ---------------------------------------------------------------------------
# transport-common parity: api / switch / tree + node variants
# (``ApiCommandHandler``, ``{Fetch,Modify}SwitchCommandHandler``,
# ``FetchJsonTreeCommandHandler``, ``FetchClusterNodeByIdCommandHandler``,
# ``FetchSimpleClusterNodeCommandHandler``)
# ---------------------------------------------------------------------------


@command_mapping("api", "list all supported commands")
def cmd_api(params, body):
    from sentinel_tpu_torch.transport.command import list_commands

    return [
        {"url": f"/{name}", "desc": desc}
        for name, desc in sorted(list_commands().items())
    ]


@command_mapping("getSwitch", "global guard switch state")
def cmd_get_switch(params, body):
    from sentinel_tpu_torch.local.sph import is_enabled

    return {"enabled": is_enabled()}


@command_mapping("setSwitch", "toggle the global guard switch; value=true|false")
def cmd_set_switch(params, body):
    from sentinel_tpu_torch.local.sph import set_enabled as sph_set_enabled

    value = str(params.get("value", "")).lower()
    if value not in ("true", "false"):
        return {"error": "value must be true or false"}
    sph_set_enabled(value == "true")
    return "success"


@command_mapping("jsonTree", "invocation tree as JSON")
def cmd_json_tree(params, body):
    from sentinel_tpu_torch.local import context as ctx_mod

    now = _clock.now_ms()

    def node_dict(node):
        return {
            "id": node.resource.name,
            "passQps": node.pass_qps(now),
            "blockQps": node.block_qps(now),
            "averageRt": node.avg_rt(now),
            "threadNum": node.cur_thread_num,
            "children": [node_dict(child) for child in node.children],
        }

    return node_dict(ctx_mod.root())


@command_mapping("clusterNodeById", "one resource's statistics; id=<resource>")
def cmd_cluster_node_by_id(params, body):
    from sentinel_tpu_torch.local.chain import get_cluster_node

    name = params.get("id", "")
    cn = get_cluster_node(name)
    if cn is None:
        return {}
    now = _clock.now_ms()
    return {
        "resourceName": name,
        "passQps": cn.pass_qps(now),
        "blockQps": cn.block_qps(now),
        "totalQps": cn.total_qps(now),
        "averageRt": cn.avg_rt(now),
        "exceptionQps": cn.exception_qps(now),
        "threadNum": cn.cur_thread_num,
        "oneMinutePass": cn.total_pass_minute(now),
    }


@command_mapping("cnode", "plain-text per-resource statistics table")
def cmd_cnode(params, body):
    from sentinel_tpu_torch.local.chain import cluster_node_map

    now = _clock.now_ms()
    lines = ["resource passQps blockQps totalQps rt threads"]
    for name, cn in sorted(cluster_node_map().items()):
        lines.append(
            f"{name} {cn.pass_qps(now):g} {cn.block_qps(now):g} "
            f"{cn.total_qps(now):g} {cn.avg_rt(now):g} {cn.cur_thread_num}"
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# cluster-server command set (``sentinel-cluster-server-default/.../command/
# handler/``): rule fetch/modify per namespace, config fetch/modify,
# namespace set, server info, per-namespace metrics
# ---------------------------------------------------------------------------


def _embedded_service():
    from sentinel_tpu_torch.cluster import api as cluster_api

    service = cluster_api.get_embedded_server()
    if service is None:
        return None, {"error": "this machine is not a token server"}
    return service, None


def _flow_rule_to_dict(rule) -> dict:
    d = {
        "flowId": rule.flow_id,
        "count": rule.count,
        "thresholdType": int(rule.mode),
        "namespace": rule.namespace,
    }
    if int(rule.control_behavior) != 0:
        # FlowRule's traffic-shaping knobs, dashboard field names
        d["controlBehavior"] = int(rule.control_behavior)
        d["warmUpPeriodSec"] = int(rule.warm_up_period_sec)
        d["coldFactor"] = int(rule.cold_factor)
        d["maxQueueingTimeMs"] = int(rule.max_queueing_time_ms)
    return d


def _flow_rule_from_dict(d: dict, namespace: str):
    from sentinel_tpu_torch.engine import ClusterFlowRule
    from sentinel_tpu_torch.engine.rules import ThresholdMode

    return ClusterFlowRule(
        flow_id=int(d["flowId"]),
        count=float(d["count"]),
        mode=ThresholdMode(int(d.get("thresholdType", 0))),
        namespace=namespace,
        control_behavior=int(d.get("controlBehavior", 0)),
        warm_up_period_sec=int(d.get("warmUpPeriodSec", 10)),
        cold_factor=int(d.get("coldFactor", 3)),
        max_queueing_time_ms=int(d.get("maxQueueingTimeMs", 500)),
    )


@command_mapping("cluster/server/flowRules", "cluster flow rules [namespace=]")
def cmd_cluster_server_flow_rules(params, body):
    service, err = _embedded_service()
    if err:
        return err
    return [
        _flow_rule_to_dict(r)
        for r in service.current_rules(params.get("namespace"))
    ]


@command_mapping(
    "cluster/server/modifyFlowRules",
    "replace one namespace's cluster flow rules; namespace=&data=[...]",
)
def cmd_cluster_server_modify_flow_rules(params, body):
    service, err = _embedded_service()
    if err:
        return err
    namespace = params.get("namespace")
    if not namespace:
        return {"error": "namespace cannot be empty"}
    data = json.loads(body or params.get("data", "[]"))
    service.load_namespace_rules(
        namespace, [_flow_rule_from_dict(d, namespace) for d in data]
    )
    return "success"


@command_mapping(
    "cluster/server/paramRules", "cluster param-flow rules [namespace=]"
)
def cmd_cluster_server_param_rules(params, body):
    service, err = _embedded_service()
    if err:
        return err
    return [
        {
            "flowId": r.flow_id,
            "count": r.count,
            "namespace": r.namespace,
            "itemThresholds": [list(t) for t in (r.item_thresholds or ())],
        }
        for r in service.current_param_rules(params.get("namespace"))
    ]


@command_mapping(
    "cluster/server/modifyParamRules",
    "replace one namespace's cluster param rules; namespace=&data=[...]",
)
def cmd_cluster_server_modify_param_rules(params, body):
    from sentinel_tpu_torch.cluster.token_service import ClusterParamFlowRule

    service, err = _embedded_service()
    if err:
        return err
    namespace = params.get("namespace")
    if not namespace:
        return {"error": "namespace cannot be empty"}
    data = json.loads(body or params.get("data", "[]"))
    rules = [
        ClusterParamFlowRule(
            flow_id=int(d["flowId"]),
            count=float(d["count"]),
            item_thresholds=tuple(
                (int(h), float(c)) for h, c in d.get("itemThresholds", [])
            ) or None,
            namespace=namespace,
        )
        for d in data
    ]
    service.load_namespace_param_rules(namespace, rules)
    return "success"


@command_mapping("cluster/server/fetchConfig", "token-server config view")
def cmd_cluster_server_fetch_config(params, body):
    service, err = _embedded_service()
    if err:
        return err
    out = dict(service.config_snapshot())
    with _EMBEDDED_LOCK:
        server = _EMBEDDED_SERVER["server"]
    if server is not None:
        out["port"] = server.port
    return out


@command_mapping(
    "cluster/server/modifyFlowConfig",
    "modify dynamic flow config; data={maxAllowedQps}",
)
def cmd_cluster_server_modify_flow_config(params, body):
    service, err = _embedded_service()
    if err:
        return err
    data = json.loads(body or params.get("data", "{}"))
    static_keys = {"exceedCount", "maxOccupyRatio", "intervalMs",
                   "sampleCount"} & set(data)
    if static_keys:
        # these are the service's geometry here (EngineConfig is fixed at
        # construction: the device state's shape, the rule table's and the
        # kernels' launch shapes follow from it); changing them means
        # re-provisioning the server, unlike the reference's mutable
        # statics — be explicit
        return {"error": "static engine config cannot change at runtime: "
                + ", ".join(sorted(static_keys))}
    if "maxAllowedQps" in data:
        service.set_max_allowed_qps(float(data["maxAllowedQps"]))
    return "success"


@command_mapping(
    "cluster/server/modifyTransportConfig",
    "move the token-server transport; data={port}",
)
def cmd_cluster_server_modify_transport_config(params, body):
    data = json.loads(body or params.get("data", "{}"))
    port = int(data.get("port", 0))
    if not port:
        return {"error": "port required"}
    with _EMBEDDED_LOCK:
        server = _EMBEDDED_SERVER["server"]
        if server is None:
            return {"error": "this machine is not a token server"}
        if server.port == port:
            return "success"
        _EMBEDDED_SERVER["server"] = None
        # class-, service-, and tuning-preserving rebind with rollback —
        # kernels stay warm either way
        _EMBEDDED_SERVER["server"] = _rebind_server_port(server, port)
    return "success"


@command_mapping(
    "cluster/server/modifyNamespaceSet", "set served namespaces; data=[...]"
)
def cmd_cluster_server_modify_namespace_set(params, body):
    service, err = _embedded_service()
    if err:
        return err
    data = json.loads(body or params.get("data", "[]"))
    service.namespace_set = set(str(ns) for ns in data)
    return "success"


@command_mapping("cluster/server/info", "token-server info (connections, config)")
def cmd_cluster_server_info(params, body):
    service, err = _embedded_service()
    if err:
        return err
    with _EMBEDDED_LOCK:
        server = _EMBEDDED_SERVER["server"]
    info = {
        "appName": SentinelConfig.get("project.name") or "sentinel-tpu",
        "namespaceSet": service.served_namespaces(),
        "flow": service.config_snapshot(),
        "embedded": server is not None,
    }
    if server is not None:
        info["port"] = server.port
        info["connection"] = [
            {"namespace": ns, "connectedCount": len(addrs),
             "clients": addrs}
            for ns, addrs in sorted(server.connections.snapshot().items())
        ]
    return info


@command_mapping(
    "cluster/server/metricList", "per-flow metrics for a namespace; namespace="
)
def cmd_cluster_server_metric_list(params, body):
    service, err = _embedded_service()
    if err:
        return err
    namespace = params.get("namespace")
    if not namespace:
        return {"error": "namespace cannot be empty"}
    flow_ids = {r.flow_id for r in service.current_rules(namespace)}
    snapshot = service.metrics_snapshot()
    return {
        str(fid): metrics
        for fid, metrics in snapshot.items()
        if fid in flow_ids
    }
