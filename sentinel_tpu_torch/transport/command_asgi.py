"""ASGI-embedded command center: serve the command surface from the app's
own web server instead of a dedicated thread server (the port's copy of
``sentinel_tpu/transport/command_asgi.py``).

The reference ships alternative command-center transports so the control
plane can ride the application's existing HTTP stack —
``sentinel-transport-netty-http``'s ``NettyHttpCommandCenter.java:36`` runs
the handlers on the app's netty event loop, and the spring-mvc variant mounts
them as controllers. The Python-ecosystem analog of both is one thing: an
ASGI app. Mount it in the server you already run (uvicorn/hypercorn,
FastAPI/Starlette sub-app, etc.):

    from sentinel_tpu_torch.transport.command_asgi import command_asgi_app
    app.mount("/sentinel", command_asgi_app())        # Starlette/FastAPI
    # or serve it standalone: uvicorn.run(command_asgi_app(), port=8719)

The same ``@command_mapping`` registry backs every transport, so handlers
registered by extensions appear here exactly as on the thread server
(``SimpleHttpCommandCenter``), and the dashboard talks to either
interchangeably. Handlers stay sync (they mutate rule managers guarded by
locks); they run in a worker thread via ``asyncio.to_thread`` so a slow
command (e.g. a promote that compiles kernels) never stalls the app's event
loop — the same isolation the netty variant gets from its business group.

Security stance matches ``CommandCenter``: the surface mutates rules with no
auth, so mount it where only operators can reach it (the reference binds
loopback by default for the same reason).
"""

from __future__ import annotations

import asyncio
import urllib.parse
from typing import Iterable, Optional, Tuple

from sentinel_tpu_torch.core.httpd import MAX_BODY_BYTES
from sentinel_tpu_torch.transport.command import ServerFactory, _route


def command_asgi_app(
    max_body_bytes: int = MAX_BODY_BYTES,
    server_factory: Optional[ServerFactory] = None,
):
    """Build the ASGI callable. Importing the default handler set happens
    here (like ``CommandCenter.start``) so a bare mount serves all 30+
    commands without extra wiring. ``server_factory`` is the
    ``CommandCenter``'s."""
    from sentinel_tpu_torch.transport import handlers  # noqa: F401

    async def app(scope, receive, send) -> None:
        if scope["type"] == "lifespan":
            # cooperate with servers that run the lifespan protocol
            while True:
                message = await receive()
                if message["type"] == "lifespan.startup":
                    await send({"type": "lifespan.startup.complete"})
                elif message["type"] == "lifespan.shutdown":
                    await send({"type": "lifespan.shutdown.complete"})
                    return
        if scope["type"] != "http":
            raise RuntimeError(f"unsupported scope type {scope['type']!r}")
        # strip('/') (both sides) to match the thread server's routing
        # (httpd.py) — trailing-slash URLs must resolve identically on
        # every transport. Mounted sub-apps arrive with root_path already
        # removed by the framework, so no extra handling is needed.
        name = scope.get("path", "/").strip("/")
        params = {
            k: v[0]
            for k, v in urllib.parse.parse_qs(
                scope.get("query_string", b"").decode("latin-1")
            ).items()
        }
        body = bytearray()
        while True:
            message = await receive()
            if message["type"] != "http.request":
                return  # client disconnected before the body arrived
            body.extend(message.get("body", b""))
            if len(body) > max_body_bytes:
                await _respond(send, 413, b"body too large",
                               "text/plain; charset=utf-8")
                return
            if not message.get("more_body", False):
                break
        status, text, content_type = await asyncio.to_thread(
            _route, scope.get("method", "GET"), name, params,
            body.decode("utf-8", errors="replace"), server_factory,
        )
        await _respond(send, status, text.encode(), content_type)

    return app


async def _respond(send, status: int, body: bytes, content_type: str) -> None:
    headers: Iterable[Tuple[bytes, bytes]] = [
        (b"content-type", content_type.encode()),
        (b"content-length", str(len(body)).encode()),
    ]
    await send({
        "type": "http.response.start",
        "status": status,
        "headers": list(headers),
    })
    await send({"type": "http.response.body", "body": body})
