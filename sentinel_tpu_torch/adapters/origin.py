"""Cross-service origin propagation for the HTTP adapters.

The reference's RPC adapters carry the caller's identity through framework
attachments so authority rules work across service hops — e.g. the dubbo
provider filter reads the application name the consumer filter attached
(``SentinelDubboProviderFilter.java``), and the servlet filter falls back to
an ``S-user`` header (``CommonFilter``). HTTP has no attachment channel, so
this module standardizes one header both directions agree on:

- **Outbound** (``adapters/http_client.py`` requests/httpx wrappers): inject
  ``X-Sentinel-Origin: <this agent's app name>``.
- **Inbound** (asgi / wsgi / aiohttp / tornado default origin parsers):
  prefer ``X-Sentinel-Origin``, then the legacy ``S-User`` user header, then
  the peer IP.

The gRPC interceptors carry the same value in metadata (their natural
attachment channel); this header is the plain-HTTP equivalent.

Security note (same stance as the reference's header fallback): the header
is caller-asserted. Authority rules gate *cooperating* services by name —
for untrusted edges, keep the peer-IP fallback or a gateway-verified header.
"""

from __future__ import annotations

from typing import Dict, Optional

ORIGIN_HEADER = "X-Sentinel-Origin"
# legacy user-identity header the servlet CommonFilter reads
USER_HEADER = "S-User"

_WSGI_ORIGIN_KEY = "HTTP_X_SENTINEL_ORIGIN"
_WSGI_USER_KEY = "HTTP_S_USER"


def origin_value() -> str:
    """What this agent advertises as its origin: the configured app name
    (the dubbo consumer attaches ``ApplicationName`` the same way)."""
    from sentinel_tpu_torch.core.config import SentinelConfig

    return SentinelConfig.app_name()


def origin_headers() -> Dict[str, str]:
    """Headers an outbound HTTP call should carry."""
    value = origin_value()
    return {ORIGIN_HEADER: value} if value else {}


def inject(headers: Optional[dict]) -> dict:
    """Merge the origin header into a (possibly None) header mapping without
    overriding an explicit caller value."""
    merged = dict(headers or {})
    if not any(k.lower() == ORIGIN_HEADER.lower() for k in merged):
        merged.update(origin_headers())
    return merged


def from_wsgi(environ) -> str:
    return (
        environ.get(_WSGI_ORIGIN_KEY, "")
        or environ.get(_WSGI_USER_KEY, "")
        or environ.get("REMOTE_ADDR", "")
    )


def from_asgi_scope(scope) -> str:
    want_origin = ORIGIN_HEADER.lower().encode()
    want_user = USER_HEADER.lower().encode()
    origin = user = ""
    for name, value in scope.get("headers") or ():
        lowered = name.lower()
        if lowered == want_origin and value:
            origin = value.decode("latin-1")
        elif lowered == want_user and value:
            user = value.decode("latin-1")
    if origin or user:
        return origin or user
    client = scope.get("client")
    return client[0] if client else ""


def from_headers(headers, fallback: str = "") -> str:
    """Case-insensitive mapping (aiohttp/tornado header objects)."""
    return (
        headers.get(ORIGIN_HEADER, "")
        or headers.get(USER_HEADER, "")
        or fallback
    )
