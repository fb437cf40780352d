"""Embedded HTTP command center (the port's copy of
``sentinel_tpu/transport/command.py``).

Analog of ``SimpleHttpCommandCenter.java:48`` + the ``@CommandMapping``
handler SPI (``command/CommandHandler.java``): ``GET/POST /<command>?args``
dispatches to a registered handler; ``/api`` lists all commands
(``ApiCommandHandler``). Handlers register via the ``command_handler``
registry, so extensions add endpoints exactly like the reference's SPI.

A command center may carry a ``server_factory``: the door that
``setClusterMode`` mode 1 starts (see ``transport/handlers.py``). Its
router hands it to the handlers of each request it routes through
:data:`SERVER_FACTORY`, so the handler SPI keeps its two arguments.
"""

from __future__ import annotations

import contextvars
import functools
import json
from typing import Callable, Dict, Optional

from sentinel_tpu_torch.core.httpd import HttpService, Response, json_response
from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.core.registry import registry

command_registry = registry("command_handler")

# handler signature: (params: Dict[str, str], body: str) -> str | dict
CommandHandler = Callable[[Dict[str, str], str], object]

_commands: Dict[str, tuple] = {}  # name -> (desc, handler)

# (server_cls, host, port) -> a token server, not started: the door that
# setClusterMode mode 1 runs (transport/handlers.py::apply_cluster_mode)
ServerFactory = Callable[[type, str, int], object]

# the server factory of the command center routing the current request
# (None: the reference's DefaultTokenService(), on the card)
SERVER_FACTORY: contextvars.ContextVar[Optional[ServerFactory]] = (
    contextvars.ContextVar("sentinel_server_factory", default=None)
)


def command_mapping(name: str, desc: str = ""):
    """``@CommandMapping(name, desc)`` analog."""

    def deco(fn: CommandHandler) -> CommandHandler:
        _commands[name] = (desc, fn)
        return fn

    return deco


def get_command(name: str):
    entry = _commands.get(name)
    return entry[1] if entry else None


def list_commands() -> Dict[str, str]:
    return {name: desc for name, (desc, _) in _commands.items()}


def _route(
    method: str,
    name: str,
    params: Dict[str, str],
    body: str,
    server_factory: Optional[ServerFactory] = None,
) -> Response:
    handler = get_command(name)
    if handler is None and name == "api":
        # fallback if the default handler set was never imported
        return json_response(200, json.dumps(list_commands()))
    if handler is None:
        return json_response(404, f"Unknown command `{name}`; see /api")
    token = SERVER_FACTORY.set(server_factory)
    try:
        result = handler(params, body)
    except Exception as e:
        record_log.exception("command %s failed", name)
        return json_response(500, f"command failed: {e}")
    finally:
        SERVER_FACTORY.reset(token)
    if isinstance(result, tuple) and len(result) == 3:
        return result  # handler provided a full (status, body, content-type)
    if isinstance(result, (dict, list)):
        return json_response(200, json.dumps(result))
    return json_response(200, str(result))


class CommandCenter:
    def __init__(
        self,
        host: Optional[str] = None,
        port: int = 8719,
        server_factory: Optional[ServerFactory] = None,
    ):
        # loopback by default: the command surface mutates rules with no
        # auth; exposing it beyond the host is an explicit operator decision
        # (csp.sentinel.api.port.binding, the reference's key for this)
        from sentinel_tpu_torch.core.config import SentinelConfig

        host = host or SentinelConfig.get(
            "csp.sentinel.api.port.binding"
        ) or "127.0.0.1"
        router = functools.partial(_route, server_factory=server_factory)
        self._service = HttpService(
            router, host, port, name="sentinel-command-center"
        )

    @property
    def host(self) -> str:
        return self._service.host

    @property
    def port(self) -> int:
        return self._service.port

    def start(self) -> "CommandCenter":
        # make sure the default handlers are registered
        from sentinel_tpu_torch.transport import handlers  # noqa: F401

        self._service.start()
        return self

    def stop(self) -> None:
        self._service.stop()
