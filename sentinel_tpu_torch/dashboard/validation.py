"""Server-side rule validation for the console CRUD routes.

Behavioral analog of the reference controllers' ``checkEntityInternal``
chains (``FlowControllerV1.java:89-134``, ``DegradeController.java:169-215``,
``SystemController``, ``AuthorityRuleController``, ``ParamFlowRuleController``,
``GatewayFlowRuleController``): a malformed rule must be rejected with a
named reason BEFORE it is stored or pushed to any agent — never fanned out
to fail on every machine. App/ip/port identity checks live in the routes
(our dashboard pushes per-app, not per-machine), so validators here cover
the rule payload itself.

Each validator returns an error string, or ``None`` when the rule is valid.
"""

from __future__ import annotations

from typing import Optional


def _num(d: dict, key: str):
    v = d.get(key)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return v


def _require_resource(d: dict) -> Optional[str]:
    if not str(d.get("resource", "") or "").strip():
        return "resource can't be null or empty"
    return None


def validate_flow(d: dict) -> Optional[str]:
    """``FlowControllerV1.checkEntityInternal`` contract."""
    err = _require_resource(d)
    if err:
        return err
    if not str(d.get("limitApp", "default") or "").strip():
        return "limitApp can't be null or empty"
    grade = d.get("grade", 1)
    if grade not in (0, 1):
        return f"grade must be 0 or 1, but {grade} got"
    count = _num(d, "count") if "count" in d else 0
    if count is None or count < 0:
        return "count should be at least zero"
    strategy = d.get("strategy", 0)
    if strategy not in (0, 1, 2):
        return f"invalid strategy: {strategy}"
    if strategy != 0 and not str(d.get("refResource", "") or "").strip():
        return "refResource can't be null or empty when strategy!=0"
    cb = d.get("controlBehavior", 0)
    if cb not in (0, 1, 2, 3):
        return f"invalid controlBehavior: {cb}"
    if cb in (1, 3):
        warm = _num(d, "warmUpPeriodSec") if "warmUpPeriodSec" in d else 10
        if warm is None or warm <= 0:
            return "warmUpPeriodSec should be positive when controlBehavior"\
                " uses warm-up"
    if cb in (2, 3):
        q = _num(d, "maxQueueingTimeMs") if "maxQueueingTimeMs" in d else 500
        if q is None or q < 0:
            return "maxQueueingTimeMs can't be negative when controlBehavior"\
                " uses pacing"
    if d.get("clusterMode") and not isinstance(
        d.get("clusterConfig", {}), dict
    ):
        return "cluster config should be valid"
    return None


def validate_degrade(d: dict) -> Optional[str]:
    """``DegradeController.checkEntityInternal`` contract."""
    err = _require_resource(d)
    if err:
        return err
    count = _num(d, "count")
    if count is None or count < 0:
        return f"invalid threshold: {d.get('count')}"
    tw = _num(d, "timeWindow")
    if tw is None or tw <= 0:
        return "recoveryTimeout (timeWindow) should be positive"
    # absent defaults to 0 (slow-ratio), matching the agent-side converter
    # (datasource/converters.py:65) and the reference's int default
    grade = d.get("grade", 0)
    if grade not in (0, 1, 2):
        return f"invalid circuit breaker strategy: {grade}"
    mra = _num(d, "minRequestAmount") if "minRequestAmount" in d else 5
    if mra is None or mra <= 0:
        return "invalid minRequestAmount"
    si = _num(d, "statIntervalMs") if "statIntervalMs" in d else 1000
    if si is None or si <= 0:
        return "invalid statIntervalMs"
    if grade == 0 and "slowRatioThreshold" in d:
        # absent is fine: the agent-side converter defaults it to 1.0
        # (datasource/converters.py); a PRESENT value must be a ratio
        ratio = _num(d, "slowRatioThreshold")
        if ratio is None or not (0 <= ratio <= 1):
            return "slowRatioThreshold must be in [0, 1] for the slow-ratio"\
                " strategy"
    return None


def validate_system(d: dict) -> Optional[str]:
    """``SystemController`` contract: at least one threshold, sane ranges."""
    keys = ("highestSystemLoad", "highestCpuUsage", "qps", "avgRt",
            "maxThread")
    set_keys = [k for k in keys if d.get(k) is not None]
    if not set_keys:
        return "at least one threshold must be set"
    for k in set_keys:
        v = _num(d, k)
        if v is None or v < 0:
            return f"invalid {k}: {d.get(k)}"
        if k == "highestCpuUsage" and v > 1:
            return "highestCpuUsage must be in [0, 1]"
    return None


def validate_authority(d: dict) -> Optional[str]:
    err = _require_resource(d)
    if err:
        return err
    if not str(d.get("limitApp", "") or "").strip():
        return "limitApp (origins) can't be null or empty"
    if d.get("strategy", 0) not in (0, 1):
        return f"invalid strategy: {d.get('strategy')}"
    return None


def validate_param_flow(d: dict) -> Optional[str]:
    err = _require_resource(d)
    if err:
        return err
    idx = _num(d, "paramIdx")
    if idx is None or idx < 0 or int(idx) != idx:
        return f"invalid paramIdx: {d.get('paramIdx')}"
    count = _num(d, "count")
    if count is None or count < 0:
        return f"invalid count: {d.get('count')}"
    dur = _num(d, "durationInSec") if "durationInSec" in d else 1
    if dur is None or dur <= 0:
        return "durationInSec should be positive"
    return None


def validate_gateway(d: dict) -> Optional[str]:
    err = _require_resource(d)
    if err:
        return err
    if d.get("resourceMode", 0) not in (0, 1):
        return f"invalid resourceMode: {d.get('resourceMode')}"
    count = _num(d, "count")
    if count is None or count < 0:
        return f"invalid count: {d.get('count')}"
    interval = _num(d, "intervalSec") if "intervalSec" in d else 1
    if interval is None or interval <= 0:
        return "intervalSec should be positive"
    return None


VALIDATORS = {
    "flow": validate_flow,
    "degrade": validate_degrade,
    "system": validate_system,
    "authority": validate_authority,
    "paramFlow": validate_param_flow,
    "gateway": validate_gateway,
}


def validate_rule(rule_type: str, rule: dict) -> Optional[str]:
    """Error string for an invalid (type, rule) payload, else None.
    Non-dict payloads are invalid for every type."""
    if not isinstance(rule, dict):
        return "rule must be a JSON object"
    v = VALIDATORS.get(rule_type)
    return v(rule) if v else None
