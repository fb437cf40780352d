"""aiohttp server middleware (async-web adapter, the webflux analog).

Same idiom as every reference adapter (``CommonFilter.java:50``-style:
parse resource + origin → enter context → entry → proceed → trace errors →
exit): resource is ``METHOD:path``, block answers 429. Safe under asyncio
concurrency because the engine context rides a ``contextvars.ContextVar``
(each task sees its own entry stack).

Usage::

    from aiohttp import web
    from sentinel_tpu_torch.adapters.aiohttp_middleware import sentinel_middleware

    app = web.Application(middlewares=[sentinel_middleware()])
"""

from __future__ import annotations

import inspect
from typing import Callable, Optional

from sentinel_tpu_torch.local import BlockException, EntryType
from sentinel_tpu_torch.local import context as _ctx
from sentinel_tpu_torch.local.sph import entry as _entry

DEFAULT_BLOCK_BODY = {"error": "Blocked by Sentinel (flow limiting)"}


def default_resource(request) -> str:
    return f"{request.method}:{request.path}"


def default_origin(request) -> str:
    """``X-Sentinel-Origin`` → ``S-User`` → peer IP (adapters/origin.py)."""
    from sentinel_tpu_torch.adapters.origin import from_headers

    return from_headers(request.headers, request.remote or "")


def sentinel_middleware(
    resource_extractor: Callable = default_resource,
    origin_parser: Callable = default_origin,
    block_status: int = 429,
    block_handler: Optional[Callable] = None,
):
    """Build an ``@web.middleware``-conformant guard. ``block_handler``
    (request, error) → response overrides the default 429 JSON body."""
    from aiohttp import web

    @web.middleware
    async def middleware(request, handler):
        resource = resource_extractor(request)
        if not resource:
            return await handler(request)
        _ctx.enter(
            name=f"aiohttp_context:{resource}", origin=origin_parser(request)
        )
        try:
            try:
                with _entry(resource, EntryType.IN) as e:
                    try:
                        return await handler(request)
                    except web.HTTPException:
                        raise  # normal control flow, not a business error
                    except BaseException as err:
                        e.trace(err)
                        raise
            except BlockException as blocked:
                if block_handler is not None:
                    resp = block_handler(request, blocked)
                    if inspect.isawaitable(resp):  # async handlers welcome
                        resp = await resp
                    return resp
                return web.json_response(
                    DEFAULT_BLOCK_BODY, status=block_status
                )
        finally:
            _ctx.exit()

    return middleware
