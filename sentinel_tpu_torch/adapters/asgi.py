"""ASGI middleware — the Spring WebMVC/WebFlux interceptor analog.

Reference idiom (``AbstractSentinelInterceptor.java:55,88,137``,
``SentinelReactorSubscriber.java:37``): guard the request on the way in,
record the outcome on the way out. Safe under asyncio concurrency because
the engine context is a ``contextvars.ContextVar`` (each task sees its own
entry stack — the capability the reference needs ``AsyncEntry`` for).
"""

from __future__ import annotations

import json
from typing import Callable, Optional

from sentinel_tpu_torch.local import BlockException, EntryType
from sentinel_tpu_torch.local import context as _ctx
from sentinel_tpu_torch.local.sph import entry as _entry

DEFAULT_BLOCK_BODY = b'{"error": "Blocked by Sentinel (flow limiting)"}'


async def send_block_response(send, status: int, body: bytes) -> None:
    """One canonical 429 response pair (shared with the gateway middleware)."""
    await send(
        {
            "type": "http.response.start",
            "status": status,
            "headers": [
                (b"content-type", b"application/json"),
                (b"content-length", str(len(body)).encode()),
            ],
        }
    )
    await send({"type": "http.response.body", "body": body})


def default_resource(scope) -> str:
    return f"{scope.get('method', 'GET')}:{scope.get('path', '/')}"


def default_origin(scope) -> str:
    """Cross-service convention: ``X-Sentinel-Origin`` (set by the
    ``http_client`` wrappers), then the legacy ``S-User`` identity header,
    then the peer IP — see ``adapters/origin.py``."""
    from sentinel_tpu_torch.adapters.origin import from_asgi_scope

    return from_asgi_scope(scope)


class SentinelAsgiMiddleware:
    def __init__(
        self,
        app: Callable,
        resource_extractor: Callable = default_resource,
        origin_parser: Callable = default_origin,
        block_status: int = 429,
        block_body: bytes = DEFAULT_BLOCK_BODY,
    ):
        self.app = app
        self.resource_extractor = resource_extractor
        self.origin_parser = origin_parser
        self.block_status = block_status
        self.block_body = block_body

    async def __call__(self, scope, receive, send) -> None:
        if scope.get("type") != "http":
            await self.app(scope, receive, send)
            return
        resource = self.resource_extractor(scope)
        if not resource:
            await self.app(scope, receive, send)
            return
        _ctx.enter(name=f"asgi_context:{resource}", origin=self.origin_parser(scope))
        try:
            try:
                entry = _entry(resource, EntryType.IN)
            except BlockException:
                await send_block_response(send, self.block_status, self.block_body)
                return
            try:
                await self.app(scope, receive, send)
            except BaseException as err:
                entry.trace(err)
                raise
            finally:
                entry.exit()
        finally:
            _ctx.exit()
