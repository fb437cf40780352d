"""Gateway flow control: param-based rules for routes/APIs.

Analog of ``sentinel-api-gateway-adapter-common``:

- ``GatewayFlowRule`` (``rule/GatewayFlowRule.java:27``): a flow rule scoped
  to a route id or logical API, optionally keyed by a request attribute
  (client IP, host, header, URL param, cookie).
- ``GatewayRuleConverter`` (``rule/GatewayRuleConverter.java``): each gateway
  rule becomes a hot-param rule — the request attribute is the hot param.
  Rules without a param item get a synthetic constant param so they still
  ride the same vectorized param path.
- ``GatewayParamParser`` (``param/GatewayParamParser.java:34,51``): pulls the
  per-rule attribute values out of the request into the args tuple, applying
  the item's match strategy (exact/prefix/regex/contains); non-matching
  values collapse into one "not matched" bucket.
- The param args feed the ordinary ``ParamFlowSlot`` — the reference inserts
  a dedicated ``GatewayFlowSlot`` at order −4000 whose checker is the
  param-flow checker; reusing ``ParamFlowSlot`` here is the same pipeline
  with one fewer moving part.
"""

from __future__ import annotations

import enum
import re
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from sentinel_tpu_torch.local import ParamFlowItem, ParamFlowRule, ParamFlowRuleManager
from sentinel_tpu_torch.local import context as _ctx
from sentinel_tpu_torch.local.base import BlockException, EntryType
from sentinel_tpu_torch.local.flow import ControlBehavior, FlowGrade
from sentinel_tpu_torch.local.sph import entry as _entry


class ResourceMode(enum.IntEnum):
    """``SentinelGatewayConstants``: rule targets a route id or a custom API."""

    ROUTE_ID = 0
    CUSTOM_API_NAME = 1


class ParseStrategy(enum.IntEnum):
    """Where the hot param comes from (``SentinelGatewayConstants.PARAM_PARSE_STRATEGY_*``)."""

    CLIENT_IP = 0
    HOST = 1
    HEADER = 2
    URL_PARAM = 3
    COOKIE = 4


class MatchStrategy(enum.IntEnum):
    """How the extracted value is matched (``PARAM_MATCH_STRATEGY_*``)."""

    EXACT = 0
    PREFIX = 1
    REGEX = 2
    CONTAINS = 3


# values that fail the match pattern share one bucket; absent values another
NOT_MATCH = "$NM"
ABSENT = "$D"


@dataclass
class GatewayParamFlowItem:
    """``GatewayParamFlowItem.java`` — the keyed attribute of a gateway rule."""

    parse_strategy: ParseStrategy = ParseStrategy.CLIENT_IP
    field_name: Optional[str] = None  # header/url-param/cookie name
    pattern: Optional[str] = None
    match_strategy: MatchStrategy = MatchStrategy.EXACT


@dataclass
class GatewayFlowRule:
    """``GatewayFlowRule.java:27``."""

    resource: str  # route id or API name
    resource_mode: ResourceMode = ResourceMode.ROUTE_ID
    count: float = 0.0
    grade: FlowGrade = FlowGrade.QPS
    interval_sec: int = 1
    control_behavior: ControlBehavior = ControlBehavior.DEFAULT
    burst: int = 0
    max_queueing_time_ms: int = 500
    param_item: Optional[GatewayParamFlowItem] = None


class RequestAdapter:
    """Framework-neutral request view the parser reads from. Adapters (WSGI,
    ASGI, any gateway) implement these five accessors."""

    def client_ip(self) -> str:
        return ""

    def host(self) -> str:
        return ""

    def header(self, name: str) -> Optional[str]:
        return None

    def url_param(self, name: str) -> Optional[str]:
        return None

    def cookie(self, name: str) -> Optional[str]:
        return None


@dataclass
class DictRequestAdapter(RequestAdapter):
    """Simple adapter over plain dicts (tests, WSGI environ pre-digestion)."""

    ip: str = ""
    host_name: str = ""
    headers: Dict[str, str] = field(default_factory=dict)
    params: Dict[str, str] = field(default_factory=dict)
    cookies: Dict[str, str] = field(default_factory=dict)

    def client_ip(self) -> str:
        return self.ip

    def host(self) -> str:
        return self.host_name

    def header(self, name: str) -> Optional[str]:
        # case-insensitive like HTTP headers: adapters normalize keys to
        # lowercase, rules are usually written canonically ("X-Api-Key") —
        # two dict gets cover both; the scan is only for hand-built dicts
        # with exotic casing
        value = self.headers.get(name)
        if value is None:
            value = self.headers.get(name.lower())
        if value is not None:
            return value
        lname = name.lower()
        for key, val in self.headers.items():
            if key.lower() == lname:
                return val
        return None

    def url_param(self, name: str) -> Optional[str]:
        return self.params.get(name)

    def cookie(self, name: str) -> Optional[str]:
        return self.cookies.get(name)


def _extract(item: GatewayParamFlowItem, request: RequestAdapter) -> str:
    s = item.parse_strategy
    if s == ParseStrategy.CLIENT_IP:
        raw = request.client_ip()
    elif s == ParseStrategy.HOST:
        raw = request.host()
    elif s == ParseStrategy.HEADER:
        raw = request.header(item.field_name or "")
    elif s == ParseStrategy.URL_PARAM:
        raw = request.url_param(item.field_name or "")
    else:
        raw = request.cookie(item.field_name or "")
    if raw is None or raw == "":
        return ABSENT
    if item.pattern:
        m = item.match_strategy
        if m == MatchStrategy.EXACT:
            matched = raw == item.pattern
        elif m == MatchStrategy.PREFIX:
            matched = raw.startswith(item.pattern)
        elif m == MatchStrategy.REGEX:
            matched = re.search(item.pattern, raw) is not None
        else:
            matched = item.pattern in raw
        if not matched:
            return NOT_MATCH
    return raw


class GatewayRuleManager:
    """Converts gateway rules to hot-param rules and parses request params.

    ``loadRules`` → ``GatewayRuleConverter.applyToParamRule`` analog: gateway
    rule *i* for a resource becomes a ``ParamFlowRule`` with
    ``param_idx = i``; ``parse(resource, request)`` then builds the aligned
    args tuple for ``entry(..., args=...)``.
    """

    _lock = threading.RLock()
    _rules: Dict[str, List[GatewayFlowRule]] = {}

    @classmethod
    def load_rules(cls, rules: Sequence[GatewayFlowRule]) -> None:
        grouped: Dict[str, List[GatewayFlowRule]] = {}
        for rule in rules:
            if not rule.resource or rule.count < 0:
                continue
            grouped.setdefault(rule.resource, []).append(rule)
        param_rules: List[ParamFlowRule] = []
        for resource, lst in grouped.items():
            for idx, rule in enumerate(lst):
                param_rules.append(
                    ParamFlowRule(
                        resource=resource,
                        param_idx=idx,
                        count=rule.count,
                        grade=rule.grade,
                        duration_sec=rule.interval_sec,
                        burst_count=rule.burst,
                        control_behavior=rule.control_behavior,
                        max_queueing_time_ms=rule.max_queueing_time_ms,
                    )
                )
        with cls._lock:
            # the gateway owns every resource it EVER named: rules generated
            # for resources dropped from the new set must be unloaded too,
            # not preserved as if they were user-defined param rules
            gateway_owned = set(cls._rules) | set(grouped)
            cls._rules = grouped
            existing = [
                r
                for res, lst in ParamFlowRuleManager.all_rules().items()
                if res not in gateway_owned
                for r in lst
            ]
            ParamFlowRuleManager.load_rules(existing + param_rules)

    @classmethod
    def rules_for(cls, resource: str) -> List[GatewayFlowRule]:
        with cls._lock:
            return list(cls._rules.get(resource, []))

    @classmethod
    def parse(cls, resource: str, request: RequestAdapter) -> Tuple[str, ...]:
        """``GatewayParamParser.parseParameterFor``: one arg per rule, indexed
        by the rule's position; rules without a param item get a constant so
        the whole rule behaves like a plain flow rule on the param path."""
        args = []
        for rule in cls.rules_for(resource):
            if rule.param_item is None:
                args.append(ABSENT)
            else:
                args.append(_extract(rule.param_item, request))
        return tuple(args)

    @classmethod
    def entry(cls, resource: str, request: RequestAdapter,
              origin: str = "", count: int = 1):
        """Guard a gateway route: parse params, enter the slot chain.
        Raises ``BlockException`` on a block verdict."""
        args = cls.parse(resource, request)
        _ctx.enter(name=GatewayGuard.CONTEXT_NAME, origin=origin)
        return _entry(resource, EntryType.IN, count, args)

    @classmethod
    def reset_for_tests(cls) -> None:
        with cls._lock:
            cls._rules = {}


class GatewayGuard:
    """Guard one gateway request: the route resource PLUS every custom API
    whose path predicates match (``GatewayApiMatcherManager`` pick), each
    entered with its own parsed params — the reference adapters' doSentinelEntry
    sequence (route entry, then one entry per matching ApiDefinition).

    Use as a context manager; raises ``BlockException`` from ``__enter__``
    with nothing left entered if ANY resource blocks.
    """

    def __init__(self, route: str, request: RequestAdapter, path: str = "",
                 origin: str = ""):
        from sentinel_tpu_torch.adapters.gateway_api import GatewayApiMatcherManager

        self.route = route
        self.request = request
        self.path = path
        self.origin = origin
        self._matcher = GatewayApiMatcherManager
        self._entries = []
        self._ctx_entered = False

    # One fixed entrance-context for all gateway traffic (the reference's
    # GATEWAY_CONTEXT prefix is bounded by ROUTE IDS; a WSGI/ASGI front only
    # has raw paths, whose cardinality would exhaust the context-name cap
    # and silently disable flow control past it). Per-route stats still
    # exist — resources are per-route; only the entrance node is shared.
    CONTEXT_NAME = "sentinel_gateway_context"

    def __enter__(self):
        _ctx.enter(name=self.CONTEXT_NAME, origin=self.origin)
        self._ctx_entered = True
        try:
            resources = [self.route]
            if self.path:
                resources.extend(
                    self._matcher.pick_matching_api_names(self.path)
                )
            for resource in resources:
                args = GatewayRuleManager.parse(resource, self.request)
                self._entries.append(_entry(resource, EntryType.IN, 1, args))
        except BaseException:
            self._unwind()
            raise
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None and not isinstance(exc, BlockException):
            self.trace(exc)
        self._unwind()
        return False

    def trace(self, exc: BaseException) -> None:
        """Record an app error on the ROUTE entry (entered first) — an
        exception-ratio rule on the route must see errors regardless of
        which custom APIs happened to match."""
        if self._entries:
            try:
                self._entries[0].trace(exc)
            except Exception:
                pass

    def _unwind(self) -> None:
        while self._entries:
            try:
                self._entries.pop().exit()
            except Exception:
                pass
        if self._ctx_entered:
            _ctx.exit()
            self._ctx_entered = False


def _parse_cookies(header_value: str) -> Dict[str, str]:
    cookies = {}
    for part in header_value.split(";"):
        if "=" in part:
            k, v = part.split("=", 1)
            cookies[k.strip()] = v.strip()
    return cookies


def _wsgi_request_adapter(environ) -> "DictRequestAdapter":
    from urllib.parse import parse_qsl

    headers = {
        k[5:].replace("_", "-").lower(): v
        for k, v in environ.items() if k.startswith("HTTP_")
    }
    return DictRequestAdapter(
        ip=environ.get("REMOTE_ADDR", ""),
        host_name=environ.get("HTTP_HOST", environ.get("SERVER_NAME", "")),
        headers=headers,
        params=dict(parse_qsl(environ.get("QUERY_STRING", ""))),
        cookies=_parse_cookies(headers.get("cookie", "")),
    )


def _asgi_request_adapter(scope) -> "DictRequestAdapter":
    from urllib.parse import parse_qsl

    headers = {
        k.decode("latin-1").lower(): v.decode("latin-1")
        for k, v in scope.get("headers", [])
    }
    client = scope.get("client")
    return DictRequestAdapter(
        ip=client[0] if client else "",
        host_name=headers.get("host", ""),
        headers=headers,
        params=dict(
            parse_qsl(scope.get("query_string", b"").decode("latin-1"))
        ),
        cookies=_parse_cookies(headers.get("cookie", "")),
    )


class SentinelGatewayWsgiMiddleware:
    """WSGI front for the gateway pipeline: route extraction → custom-API
    matching → per-resource param parsing → gateway entries. The analog of
    mounting the reference's Zuul/SCG filter at the edge.

    ``route_extractor`` should return a BOUNDED set of route ids (the
    reference's routes come from gateway config). The default — the raw
    path — is fine behind a router that normalizes paths, but a front
    serving unbounded distinct paths (REST ids in the path) must map them
    to route ids or per-resource stats grow without bound."""

    def __init__(self, app, route_extractor=None, origin_parser=None,
                 block_handler=None):
        self.app = app
        self.route_extractor = route_extractor or (
            lambda environ: environ.get("PATH_INFO", "/")
        )
        self.origin_parser = origin_parser or (
            lambda environ: environ.get("REMOTE_ADDR", "")
        )
        self.block_handler = block_handler

    def __call__(self, environ, start_response):
        route = self.route_extractor(environ)
        if not route:
            return self.app(environ, start_response)
        request = _wsgi_request_adapter(environ)
        path = environ.get("PATH_INFO", "/")
        guard = GatewayGuard(route, request, path, self.origin_parser(environ))
        try:
            # only the guard's own admission block is answered with 429 —
            # a BlockException raised by the app (nested entry) propagates,
            # because the app may already have called start_response
            guard.__enter__()
        except BlockException as e:
            if self.block_handler is not None:
                return self.block_handler(environ, start_response, e)
            body = b"Blocked by Sentinel (gateway flow limiting)"
            start_response(
                "429 Too Many Requests",
                [("Content-Type", "text/plain"),
                 ("Content-Length", str(len(body)))],
            )
            return [body]
        try:
            body = self.app(environ, start_response)
        except BaseException as err:
            guard.trace(err)
            guard._unwind()
            raise
        # exit only after the body is consumed (mirrors SentinelWsgiMiddleware):
        # streaming responses hold the entries open for their full duration
        from sentinel_tpu_torch.adapters.wsgi import _GuardedBody

        return _GuardedBody(body, guard._entries[0], guard._unwind)


class SentinelGatewayAsgiMiddleware:
    """ASGI twin of ``SentinelGatewayWsgiMiddleware``."""

    def __init__(self, app, route_extractor=None, origin_parser=None,
                 block_status: int = 429,
                 block_body: bytes = b'{"error": "Blocked by Sentinel (gateway flow limiting)"}'):
        self.app = app
        self.route_extractor = route_extractor or (
            lambda scope: scope.get("path", "/")
        )
        self.origin_parser = origin_parser or (
            lambda scope: (scope.get("client") or ("",))[0]
        )
        self.block_status = block_status
        self.block_body = block_body

    async def __call__(self, scope, receive, send):
        if scope.get("type") != "http":
            await self.app(scope, receive, send)
            return
        route = self.route_extractor(scope)
        if not route:
            await self.app(scope, receive, send)
            return
        request = _asgi_request_adapter(scope)
        path = scope.get("path", "/")
        try:
            guard = GatewayGuard(route, request, path, self.origin_parser(scope))
            guard.__enter__()
        except BlockException:
            from sentinel_tpu_torch.adapters.asgi import send_block_response

            await send_block_response(send, self.block_status, self.block_body)
            return
        try:
            await self.app(scope, receive, send)
        except BaseException as exc:
            guard.__exit__(type(exc), exc, exc.__traceback__)
            raise
        else:
            guard.__exit__(None, None, None)
