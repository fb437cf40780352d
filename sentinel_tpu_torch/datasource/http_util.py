"""Tiny stdlib HTTP helper shared by the HTTP-API datasource backends.

The reference ships one Maven submodule per config backend, each pulling the
vendor's Java client (Nacos client, CuratorFramework, etc.). Here every
backend with an HTTP API (consul, etcd v3 gateway, nacos, apollo, eureka,
spring-cloud-config) speaks it directly through urllib — no vendored SDKs,
which also keeps the image dependency-free.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, Optional, Tuple


class HttpResponse:
    def __init__(self, status: int, headers: Dict[str, str], body: bytes):
        self.status = status
        self.headers = headers
        self.body = body

    @property
    def text(self) -> str:
        return self.body.decode("utf-8", errors="replace")

    def json(self):
        return json.loads(self.text)


def request(
    url: str,
    method: str = "GET",
    params: Optional[Dict[str, str]] = None,
    data: Optional[bytes] = None,
    headers: Optional[Dict[str, str]] = None,
    timeout_s: float = 5.0,
) -> HttpResponse:
    """One HTTP exchange; non-2xx returns the response rather than raising
    (datasources treat 404 'no config yet' as empty, not an error)."""
    if params:
        url = url + ("&" if "?" in url else "?") + urllib.parse.urlencode(params)
    req = urllib.request.Request(url, data=data, method=method)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return HttpResponse(resp.status, dict(resp.headers), resp.read())
    except urllib.error.HTTPError as e:  # non-2xx still carries a body
        return HttpResponse(e.code, dict(e.headers or {}), e.read() or b"")
