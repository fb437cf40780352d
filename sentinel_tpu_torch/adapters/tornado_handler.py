"""Tornado adapter: a ``RequestHandler`` mixin guarding every HTTP verb.

Reference adapter idiom (resource + origin → context → entry → proceed →
trace → exit) mapped onto Tornado's prepare/on_finish lifecycle — the same
interceptor shape as ``AbstractSentinelInterceptor.java:55,88,137``.

Usage::

    class Hello(SentinelRequestHandlerMixin, web.RequestHandler):
        def get(self):
            self.write("hi")

Blocked requests get ``block_status`` (429) and the verb never runs.
"""

from __future__ import annotations

from typing import Optional

from sentinel_tpu_torch.local import BlockException, EntryType
from sentinel_tpu_torch.local import context as _ctx
from sentinel_tpu_torch.local.sph import entry as _entry

DEFAULT_BLOCK_BODY = '{"error": "Blocked by Sentinel (flow limiting)"}'


class SentinelRequestHandlerMixin:
    sentinel_block_status = 429
    sentinel_block_body = DEFAULT_BLOCK_BODY

    def sentinel_resource(self) -> str:
        """Override to rename/skip (return "" to leave unguarded)."""
        return f"{self.request.method}:{self.request.path}"

    def sentinel_origin(self) -> str:
        """``X-Sentinel-Origin`` → ``S-User`` → peer IP (adapters/origin.py)."""
        from sentinel_tpu_torch.adapters.origin import from_headers

        return from_headers(
            self.request.headers, self.request.remote_ip or ""
        )

    def prepare(self):
        super().prepare()
        resource = self.sentinel_resource()
        self._sentinel_entry = None
        self._sentinel_ctx = False
        if not resource:
            return
        _ctx.enter(
            name=f"tornado_context:{resource}", origin=self.sentinel_origin()
        )
        self._sentinel_ctx = True
        try:
            self._sentinel_entry = _entry(resource, EntryType.IN).__enter__()
        except BlockException:
            self._sentinel_exit_context()
            self.set_status(self.sentinel_block_status)
            self.finish(self.sentinel_block_body)

    def _sentinel_exit_context(self):
        if getattr(self, "_sentinel_ctx", False):
            _ctx.exit()
            self._sentinel_ctx = False

    def _sentinel_close(self, error: Optional[BaseException] = None):
        # getattr: Tornado can finish a request without ever calling
        # prepare() (e.g. HTTPError(405) for an unsupported method raised
        # inside _execute before the prepare hook)
        e = getattr(self, "_sentinel_entry", None)
        self._sentinel_entry = None
        if e is not None:
            if error is not None:
                e.trace(error)
            e.exit()
        self._sentinel_exit_context()

    def on_finish(self):
        self._sentinel_close()
        super().on_finish()

    def log_exception(self, typ, value, tb):
        from tornado.web import HTTPError

        # HTTPError is framework control flow (404s, 405s), not a business
        # failure — tracing it would inflate exception ratios and could trip
        # exception-ratio circuit breakers (the aiohttp middleware excludes
        # web.HTTPException for the same reason)
        if (
            value is not None
            and not isinstance(value, (BlockException, HTTPError))
        ):
            e = getattr(self, "_sentinel_entry", None)
            if e is not None:
                e.trace(value)
        super().log_exception(typ, value, tb)
