"""Shared embedded-HTTP-server scaffolding (the port's copy of
``sentinel_tpu/core/httpd.py``).

The control-plane surfaces (the command center, ``transport/command.py``;
the reference also serves its dashboard through it) are tiny threaded HTTP
services; this module owns the one copy of the handler/lifecycle plumbing
(stdlib ``ThreadingHTTPServer``, port-0 resolution, quiet logging).
"""

from __future__ import annotations

import inspect
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from sentinel_tpu_torch.core.log import record_log

# (status code, body text, content type)
Response = Tuple[int, str, str]

# (method, path-without-leading-slash, query params, body) -> Response.
# A router declaring a parameter named ``headers`` (or **kwargs) also
# receives the request headers as a keyword (an email.message.Message-like
# mapping) — used for cookie-based auth.
Router = Callable[[str, str, dict, str], Response]

# rule payloads are small; cap abuse. A dashboard pushes one namespace's
# rules at a time (cluster/server/modifyFlowRules), which stays well under it
MAX_BODY_BYTES = 4 * 1024 * 1024


def json_response(code: int, text: str) -> Response:
    return (code, text, "application/json; charset=utf-8")


def html_response(code: int, text: str) -> Response:
    return (code, text, "text/html; charset=utf-8")


class HttpService:
    """A routed, threaded HTTP server with start/stop lifecycle."""

    def __init__(self, router: Router, host: str, port: int, name: str):
        self.router = router
        self.host = host
        self.port = port
        self.name = name
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HttpService":
        router = self.router
        name = self.name
        # headers are passed as an opt-in KEYWORD, detected by name — a
        # positional count would misfire on variadic or defaulted routers
        try:
            sig_params = inspect.signature(router).parameters
            wants_headers = "headers" in sig_params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in sig_params.values()
            )
        except (TypeError, ValueError):  # builtins/partials w/o signature
            wants_headers = False

        class Handler(BaseHTTPRequestHandler):
            server_version = "SentinelTPU"

            def _dispatch(self, method: str, body: str) -> None:
                parsed = urlparse(self.path)
                params = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                try:
                    args = (method, parsed.path.strip("/"), params, body)
                    if wants_headers:
                        result = router(*args, headers=self.headers)
                    else:
                        result = router(*args)
                except Exception as e:
                    record_log.exception("%s request failed", name)
                    result = json_response(500, json.dumps({"error": str(e)}))
                # routers may append a 4th element: extra response headers
                # (e.g. Set-Cookie for the dashboard login)
                code, text, ctype = result[:3]
                extra = result[3] if len(result) > 3 else {}
                data = text.encode()
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(data)))
                    for k, v in extra.items():
                        self.send_header(k, v)
                    self.end_headers()
                    self.wfile.write(data)
                except (BrokenPipeError, ConnectionResetError):
                    # the client gave up (e.g. its timeout fired while a slow
                    # handler ran) — the work is done; dropping the response
                    # is not an error worth a traceback
                    record_log.warning(
                        "%s: client closed before response (%s)",
                        name, parsed.path,
                    )

            def do_GET(self):  # noqa: N802
                self._dispatch("GET", "")

            def _read_body(self) -> Optional[str]:
                length = int(self.headers.get("Content-Length") or 0)
                if length > MAX_BODY_BYTES:
                    self.send_response(413)
                    self.end_headers()
                    return None
                return self.rfile.read(length).decode() if length else ""

            def do_POST(self):  # noqa: N802
                body = self._read_body()
                if body is not None:
                    self._dispatch("POST", body)

            def do_PUT(self):  # noqa: N802
                body = self._read_body()
                if body is not None:
                    self._dispatch("PUT", body)

            def do_DELETE(self):  # noqa: N802
                self._dispatch("DELETE", "")

            def log_message(self, fmt, *args):  # record_log has the failures
                pass

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name=self.name
        )
        self._thread.start()
        record_log.info("%s on %s:%d", self.name, self.host, self.port)
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
