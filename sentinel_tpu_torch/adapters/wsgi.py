"""WSGI middleware — the servlet ``CommonFilter``/``CommonTotalFilter`` analog.

Reference idiom (``sentinel-web-servlet/.../CommonFilter.java:50,79``):
resource = HTTP target (optionally prefixed by method), origin parsed from
the request, block → configurable response (the reference redirects or
writes a default block page; here a 429).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from sentinel_tpu_torch.local import BlockException, EntryType
from sentinel_tpu_torch.local import context as _ctx
from sentinel_tpu_torch.local.sph import entry as _entry

DEFAULT_BLOCK_BODY = b"Blocked by Sentinel (flow limiting)"
TOTAL_RESOURCE = "wsgi_total_inbound_traffic"  # CommonTotalFilter's TOTAL_URL


def default_resource(environ) -> str:
    return f"{environ.get('REQUEST_METHOD', 'GET')}:{environ.get('PATH_INFO', '/')}"


def default_origin(environ) -> str:
    """``X-Sentinel-Origin`` → ``S-User`` → peer IP (adapters/origin.py)."""
    from sentinel_tpu_torch.adapters.origin import from_wsgi

    return from_wsgi(environ)


class SentinelWsgiMiddleware:
    """Wrap a WSGI app so every request is a guarded resource.

    ``resource_extractor(environ)`` names the resource (default
    ``METHOD:path``); return "" to skip guarding a request (the reference's
    URL-cleaner excluding e.g. static assets). ``origin_parser(environ)``
    feeds authority rules and per-origin statistics. ``with_total`` adds the
    CommonTotalFilter-style umbrella entry around every request.
    """

    def __init__(
        self,
        app: Callable,
        resource_extractor: Callable = default_resource,
        origin_parser: Callable = default_origin,
        block_handler: Optional[Callable] = None,
        with_total: bool = False,
    ):
        self.app = app
        self.resource_extractor = resource_extractor
        self.origin_parser = origin_parser
        self.block_handler = block_handler
        self.with_total = with_total

    def __call__(self, environ, start_response) -> Iterable[bytes]:
        resource = self.resource_extractor(environ)
        if not resource:
            return self.app(environ, start_response)
        origin = self.origin_parser(environ)
        _ctx.enter(name=f"wsgi_context:{resource}", origin=origin)
        total = None
        entry = None

        def finish():
            if entry is not None:
                entry.exit()
            if total is not None:
                total.exit()
            _ctx.exit()

        try:
            if self.with_total:
                total = _entry(TOTAL_RESOURCE, EntryType.IN)
            entry = _entry(resource, EntryType.IN)
        except BlockException as e:
            try:
                if self.block_handler is not None:
                    return self.block_handler(environ, start_response, e)
                start_response(
                    "429 Too Many Requests",
                    [("Content-Type", "text/plain"),
                     ("Content-Length", str(len(DEFAULT_BLOCK_BODY)))],
                )
                return [DEFAULT_BLOCK_BODY]
            finally:
                finish()
        try:
            body = self.app(environ, start_response)
        except BaseException as err:
            entry.trace(err)
            finish()
            raise
        # exit only after the body is consumed: streaming responses hold the
        # entry open for their full duration, so THREAD-grade rules see the
        # real concurrency, RT covers iteration, and iteration-time errors
        # are traced (PEP 3333 guarantees close() is called)
        return _GuardedBody(body, entry, finish)


class _GuardedBody:
    """Response-body wrapper that completes the entry on close/exhaustion."""

    def __init__(self, body: Iterable[bytes], entry, finish: Callable):
        self._body = body
        self._entry = entry
        self._finish = finish
        self._done = False

    def __iter__(self):
        try:
            for chunk in self._body:
                yield chunk
        except BaseException as err:
            self._entry.trace(err)
            raise
        finally:
            self.close()

    def close(self):
        if self._done:
            return
        self._done = True
        try:
            close = getattr(self._body, "close", None)
            if close is not None:
                close()
        finally:
            self._finish()
