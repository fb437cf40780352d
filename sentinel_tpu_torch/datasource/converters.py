"""JSON ⇄ rule converters for every rule type.

Field names follow the reference's JSON rule schema (what the dashboard and
``sentinel-demo`` file datasources exchange: camelCase ``FlowRule`` fields
etc.), so existing Sentinel rule files load unchanged.
"""

from __future__ import annotations

import json
from typing import List

from sentinel_tpu_torch.local.authority import AuthorityRule, AuthorityStrategy
from sentinel_tpu_torch.local.degrade import DegradeGrade, DegradeRule
from sentinel_tpu_torch.local.flow import ControlBehavior, FlowGrade, FlowRule, FlowStrategy
from sentinel_tpu_torch.local.param import ParamFlowItem, ParamFlowRule
from sentinel_tpu_torch.local.system_adaptive import SystemRule


def flow_rules_from_json(text: str) -> List[FlowRule]:
    return [
        FlowRule(
            resource=d["resource"],
            count=float(d.get("count", 0)),
            grade=FlowGrade(d.get("grade", 1)),
            limit_app=d.get("limitApp", "default"),
            strategy=FlowStrategy(d.get("strategy", 0)),
            ref_resource=d.get("refResource", "") or "",
            control_behavior=ControlBehavior(d.get("controlBehavior", 0)),
            warm_up_period_sec=int(d.get("warmUpPeriodSec", 10)),
            max_queueing_time_ms=int(d.get("maxQueueingTimeMs", 500)),
            cluster_mode=bool(d.get("clusterMode", False)),
            cluster_config=d.get("clusterConfig"),
        )
        for d in json.loads(text) or []
    ]


def flow_rules_to_json(rules: List[FlowRule]) -> str:
    return json.dumps(
        [
            {
                "resource": r.resource,
                "count": r.count,
                "grade": int(r.grade),
                "limitApp": r.limit_app,
                "strategy": int(r.strategy),
                "refResource": r.ref_resource,
                "controlBehavior": int(r.control_behavior),
                "warmUpPeriodSec": r.warm_up_period_sec,
                "maxQueueingTimeMs": r.max_queueing_time_ms,
                "clusterMode": r.cluster_mode,
                "clusterConfig": r.cluster_config,
            }
            for r in rules
        ],
        indent=2,
    )


def degrade_rules_from_json(text: str) -> List[DegradeRule]:
    return [
        DegradeRule(
            resource=d["resource"],
            grade=DegradeGrade(d.get("grade", 0)),
            count=float(d.get("count", 0)),
            time_window_sec=int(d.get("timeWindow", 0)),
            min_request_amount=int(d.get("minRequestAmount", 5)),
            stat_interval_ms=int(d.get("statIntervalMs", 1000)),
            slow_ratio_threshold=float(d.get("slowRatioThreshold", 1.0)),
            limit_app=d.get("limitApp", "default"),
        )
        for d in json.loads(text) or []
    ]


def degrade_rules_to_json(rules: List[DegradeRule]) -> str:
    return json.dumps(
        [
            {
                "resource": r.resource,
                "grade": int(r.grade),
                "count": r.count,
                "timeWindow": r.time_window_sec,
                "minRequestAmount": r.min_request_amount,
                "statIntervalMs": r.stat_interval_ms,
                "slowRatioThreshold": r.slow_ratio_threshold,
                "limitApp": r.limit_app,
            }
            for r in rules
        ],
        indent=2,
    )


def system_rules_from_json(text: str) -> List[SystemRule]:
    return [
        SystemRule(
            highest_system_load=float(d.get("highestSystemLoad", -1)),
            highest_cpu_usage=float(d.get("highestCpuUsage", -1)),
            qps=float(d.get("qps", -1)),
            avg_rt=float(d.get("avgRt", -1)),
            max_thread=float(d.get("maxThread", -1)),
        )
        for d in json.loads(text) or []
    ]


def system_rules_to_json(rules: List[SystemRule]) -> str:
    return json.dumps(
        [
            {
                "highestSystemLoad": r.highest_system_load,
                "highestCpuUsage": r.highest_cpu_usage,
                "qps": r.qps,
                "avgRt": r.avg_rt,
                "maxThread": r.max_thread,
            }
            for r in rules
        ],
        indent=2,
    )


def authority_rules_from_json(text: str) -> List[AuthorityRule]:
    return [
        AuthorityRule(
            resource=d["resource"],
            limit_app=d.get("limitApp", ""),
            strategy=AuthorityStrategy(d.get("strategy", 0)),
        )
        for d in json.loads(text) or []
    ]


def authority_rules_to_json(rules: List[AuthorityRule]) -> str:
    return json.dumps(
        [
            {
                "resource": r.resource,
                "limitApp": r.limit_app,
                "strategy": int(r.strategy),
            }
            for r in rules
        ],
        indent=2,
    )


def param_flow_rules_from_json(text: str) -> List[ParamFlowRule]:
    return [
        ParamFlowRule(
            resource=d["resource"],
            param_idx=int(d.get("paramIdx", 0)),
            count=float(d.get("count", 0)),
            grade=FlowGrade(d.get("grade", 1)),
            duration_sec=int(d.get("durationInSec", 1)),
            burst_count=int(d.get("burstCount", 0)),
            control_behavior=ControlBehavior(d.get("controlBehavior", 0)),
            max_queueing_time_ms=int(d.get("maxQueueingTimeMs", 0)),
            items=[
                ParamFlowItem(
                    object_value=i.get("object"), count=float(i.get("count", 0))
                )
                for i in d.get("paramFlowItemList", [])
            ],
            cluster_mode=bool(d.get("clusterMode", False)),
            cluster_config=d.get("clusterConfig"),
        )
        for d in json.loads(text) or []
    ]


def param_flow_rules_to_json(rules: List[ParamFlowRule]) -> str:
    return json.dumps(
        [
            {
                "resource": r.resource,
                "paramIdx": r.param_idx,
                "count": r.count,
                "grade": int(r.grade),
                "durationInSec": r.duration_sec,
                "burstCount": r.burst_count,
                "controlBehavior": int(r.control_behavior),
                "maxQueueingTimeMs": r.max_queueing_time_ms,
                "paramFlowItemList": [
                    {"object": i.object_value, "count": i.count} for i in r.items
                ],
                "clusterMode": r.cluster_mode,
                "clusterConfig": r.cluster_config,
            }
            for r in rules
        ],
        indent=2,
    )


def gateway_flow_rules_from_json(text: str):
    """Gateway rule schema mirrors ``GatewayFlowRule.java`` field names (what
    the reference dashboard's gateway UI exchanges)."""
    from sentinel_tpu_torch.adapters.gateway import (
        GatewayFlowRule,
        GatewayParamFlowItem,
        MatchStrategy,
        ParseStrategy,
        ResourceMode,
    )

    out = []
    for d in json.loads(text) or []:
        item = d.get("paramItem")
        out.append(
            GatewayFlowRule(
                resource=d["resource"],
                resource_mode=ResourceMode(d.get("resourceMode", 0)),
                count=float(d.get("count", 0)),
                grade=FlowGrade(d.get("grade", 1)),
                interval_sec=int(d.get("intervalSec", 1)),
                control_behavior=ControlBehavior(d.get("controlBehavior", 0)),
                burst=int(d.get("burst", 0)),
                max_queueing_time_ms=int(d.get("maxQueueingTimeoutMs", 500)),
                param_item=(
                    GatewayParamFlowItem(
                        parse_strategy=ParseStrategy(item.get("parseStrategy", 0)),
                        field_name=item.get("fieldName"),
                        pattern=item.get("pattern"),
                        match_strategy=MatchStrategy(item.get("matchStrategy", 0)),
                    )
                    if item
                    else None
                ),
            )
        )
    return out


def gateway_flow_rules_to_json(rules) -> str:
    return json.dumps(
        [
            {
                "resource": r.resource,
                "resourceMode": int(r.resource_mode),
                "count": r.count,
                "grade": int(r.grade),
                "intervalSec": r.interval_sec,
                "controlBehavior": int(r.control_behavior),
                "burst": r.burst,
                "maxQueueingTimeoutMs": r.max_queueing_time_ms,
                "paramItem": (
                    {
                        "parseStrategy": int(r.param_item.parse_strategy),
                        "fieldName": r.param_item.field_name,
                        "pattern": r.param_item.pattern,
                        "matchStrategy": int(r.param_item.match_strategy),
                    }
                    if r.param_item
                    else None
                ),
            }
            for r in rules
        ],
        indent=2,
    )


def cluster_flow_rules_from_json(text: str):
    """Cluster (token-server) rule schema: the ``FlowRule`` +
    ``ClusterFlowConfig`` subset the device engine consumes
    (``ClusterFlowRuleManager`` parses the same shape from its namespace
    datasources — ``flowId``/``count``/``thresholdType``/``namespace``)."""
    from sentinel_tpu_torch.engine import ClusterFlowRule
    from sentinel_tpu_torch.engine.rules import ThresholdMode

    return [
        ClusterFlowRule(
            flow_id=int(
                d.get("flowId", (d.get("clusterConfig") or {}).get("flowId", 0))
            ),
            count=float(d.get("count", 0)),
            mode=ThresholdMode(
                int(
                    d.get(
                        "thresholdType",
                        (d.get("clusterConfig") or {}).get("thresholdType", 0),
                    )
                )
            ),
            namespace=str(d.get("namespace", "default") or "default"),
            control_behavior=int(d.get("controlBehavior", 0)),
            warm_up_period_sec=int(d.get("warmUpPeriodSec", 10)),
            cold_factor=int(d.get("coldFactor", 3)),
            max_queueing_time_ms=int(d.get("maxQueueingTimeMs", 500)),
        )
        for d in json.loads(text) or []
    ]


def cluster_flow_rules_to_json(rules) -> str:
    docs = []
    for r in rules:
        d = {
            "flowId": r.flow_id,
            "count": r.count,
            "thresholdType": int(r.mode),
            "namespace": r.namespace,
        }
        if int(getattr(r, "control_behavior", 0)) != 0:
            d["controlBehavior"] = int(r.control_behavior)
            d["warmUpPeriodSec"] = int(r.warm_up_period_sec)
            d["coldFactor"] = int(r.cold_factor)
            d["maxQueueingTimeMs"] = int(r.max_queueing_time_ms)
        docs.append(d)
    return json.dumps(docs, indent=2)
