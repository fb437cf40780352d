"""Outbound HTTP-call guards for ``requests`` and ``httpx``.

Analog of ``sentinel-okhttp-adapter`` / ``sentinel-apache-httpclient-adapter``:
the outbound URL (normalized to ``METHOD:scheme://host/path``) is an OUT-type
resource; blocks raise ``BlockException`` before any connection is made;
HTTP errors are traced. Gated on the respective client library.

Both wrappers also attach ``X-Sentinel-Origin: <app name>`` so the callee's
Sentinel adapter sees the calling *application* as the request origin — the
dubbo consumer→provider attachment idiom for plain HTTP (see
``adapters/origin.py``). Pass ``propagate_origin=False`` to opt out.
"""

from __future__ import annotations

from typing import Callable, Optional
from urllib.parse import urlsplit

from sentinel_tpu_torch.local import BlockException, EntryType  # noqa: F401 (re-export)
from sentinel_tpu_torch.local.sph import entry as _entry


def default_resource(method: str, url: str) -> str:
    parts = urlsplit(url)
    return f"{method.upper()}:{parts.scheme}://{parts.netloc}{parts.path}"


def guarded_call(fn: Callable, method: str, url: str,
                 resource_extractor: Callable = default_resource, **kwargs):
    """Framework-neutral core: guard ``fn(**kwargs)`` as an outbound call."""
    with _entry(resource_extractor(method, url), EntryType.OUT) as e:
        try:
            return fn(**kwargs)
        except BaseException as err:
            e.trace(err)
            raise


# -- requests ---------------------------------------------------------------

def guarded_requests_session(
    session=None, resource_extractor: Callable = default_resource,
    propagate_origin: bool = True,
):
    """Wrap a ``requests.Session`` so every request is guarded."""
    import requests

    from sentinel_tpu_torch.adapters.origin import inject as _inject_origin

    session = session or requests.Session()
    inner = session.request

    def request(method, url, *args, **kwargs):
        # requests.Session.request takes headers as its 5th positional arg
        # (after params, data) — only inject via kwargs when the caller
        # didn't already pass it positionally
        if propagate_origin and len(args) < 3:
            kwargs["headers"] = _inject_origin(kwargs.get("headers"))
        with _entry(resource_extractor(method, url), EntryType.OUT) as e:
            resp = inner(method, url, *args, **kwargs)
            if resp.status_code >= 500:
                e.trace(RuntimeError(f"HTTP {resp.status_code}"))
            return resp

    session.request = request
    return session


# -- httpx ------------------------------------------------------------------

class SentinelHttpxTransport:
    """``httpx`` custom transport wrapper: ``httpx.Client(transport=...)``."""

    def __init__(self, inner=None, resource_extractor: Callable = default_resource,
                 propagate_origin: bool = True):
        import httpx

        self._inner = inner or httpx.HTTPTransport()
        self._extract = resource_extractor
        self._propagate_origin = propagate_origin

    def handle_request(self, request):
        if self._propagate_origin:
            from sentinel_tpu_torch.adapters.origin import ORIGIN_HEADER, origin_value

            if ORIGIN_HEADER not in request.headers:
                value = origin_value()
                if value:
                    request.headers[ORIGIN_HEADER] = value
        resource = self._extract(request.method, str(request.url))
        with _entry(resource, EntryType.OUT) as e:
            response = self._inner.handle_request(request)
            if response.status_code >= 500:
                e.trace(RuntimeError(f"HTTP {response.status_code}"))
            return response

    def close(self):
        self._inner.close()
