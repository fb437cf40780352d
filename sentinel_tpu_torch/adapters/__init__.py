"""Adapters: the API surface into user frameworks (``sentinel-adapter`` analog).

Every adapter follows the one idiom of the reference's 19 modules
(SURVEY.md §1 L7): parse resource name + origin from the framework request →
enter context → ``entry`` → proceed → trace on error → ``exit``.

- ``decorator``: ``@sentinel_resource`` function guard with
  block-handler/fallback dispatch (``sentinel-annotation-aspectj`` analog).
- ``wsgi``: WSGI middleware (``sentinel-web-servlet`` ``CommonFilter`` /
  ``CommonTotalFilter`` analog).
- ``asgi``: ASGI middleware (``spring-webmvc``/``webflux`` interceptor
  analog; async-safe because the context is a ``contextvars.ContextVar``).
- ``grpc_interceptor``: server + client interceptors
  (``sentinel-grpc-adapter`` analog; gated on ``grpcio``).
- ``http_client``: outbound-call guards for ``requests`` and ``httpx``
  (``sentinel-okhttp/apache-httpclient-adapter`` analog; gated).
- ``gateway``: param-based gateway flow rules + request parser
  (``sentinel-api-gateway-adapter-common`` analog).
- ``aiohttp_middleware``: aiohttp server middleware (gated on ``aiohttp``).
- ``tornado_handler``: Tornado ``RequestHandler`` mixin (gated on
  ``tornado``).
"""

from sentinel_tpu_torch.adapters.decorator import (
    sentinel_intercept,
    sentinel_resource,
)
from sentinel_tpu_torch.adapters.wsgi import SentinelWsgiMiddleware
from sentinel_tpu_torch.adapters.asgi import SentinelAsgiMiddleware
from sentinel_tpu_torch.adapters.gateway import (
    GatewayFlowRule,
    GatewayGuard,
    GatewayParamFlowItem,
    GatewayRuleManager,
    MatchStrategy,
    ParseStrategy,
    RequestAdapter,
    ResourceMode,
    SentinelGatewayAsgiMiddleware,
    SentinelGatewayWsgiMiddleware,
)
from sentinel_tpu_torch.adapters.gateway_api import (
    ApiDefinition,
    ApiPathPredicateItem,
    ApiPredicateGroupItem,
    GatewayApiDefinitionManager,
    GatewayApiMatcherManager,
    UrlMatchStrategy,
)

__all__ = [
    "sentinel_intercept",
    "sentinel_resource",
    "SentinelWsgiMiddleware",
    "SentinelAsgiMiddleware",
    "GatewayFlowRule",
    "GatewayGuard",
    "GatewayParamFlowItem",
    "GatewayRuleManager",
    "MatchStrategy",
    "ParseStrategy",
    "RequestAdapter",
    "ResourceMode",
    "SentinelGatewayAsgiMiddleware",
    "SentinelGatewayWsgiMiddleware",
    "ApiDefinition",
    "ApiPathPredicateItem",
    "ApiPredicateGroupItem",
    "GatewayApiDefinitionManager",
    "GatewayApiMatcherManager",
    "UrlMatchStrategy",
]
