"""Call context and invocation tree (the port's copy of
``sentinel_tpu/local/context.py``).

Analog of ``context/Context.java:57`` + ``ContextUtil.java:45``. The reference
binds the context to a ``ThreadLocal``; here it lives in a ``contextvars.
ContextVar`` so the same engine works under threads *and* asyncio tasks (each
task gets its own context snapshot) — a strict capability superset of the
reference's ``AsyncEntry`` machinery.
"""

from __future__ import annotations

import contextvars
import threading
from typing import Dict, Optional

from sentinel_tpu_torch.local.base import CONTEXT_DEFAULT_NAME
from sentinel_tpu_torch.local.stat import EntranceNode
from sentinel_tpu_torch.local.base import ResourceWrapper, EntryType


class Context:
    __slots__ = ("name", "origin", "entrance_node", "cur_entry", "async_mode")

    def __init__(self, name: str, entrance_node: EntranceNode, origin: str = ""):
        self.name = name
        self.origin = origin
        self.entrance_node = entrance_node
        self.cur_entry = None  # type: Optional["object"]
        self.async_mode = False


class NullContext(Context):
    """Returned when the context cap is exceeded (``NullContext.java``) —
    entries under it pass through unguarded."""

    def __init__(self):
        # entrance node unused; reuse a throwaway
        super().__init__("null_context_internal", _null_entrance())


_null_entrance_node: Optional[EntranceNode] = None


def _null_entrance() -> EntranceNode:
    global _null_entrance_node
    if _null_entrance_node is None:
        _null_entrance_node = EntranceNode(
            ResourceWrapper("null_context_internal", EntryType.IN)
        )
    return _null_entrance_node


_context_var: contextvars.ContextVar[Optional[Context]] = contextvars.ContextVar(
    "sentinel_context", default=None
)

# Cached EntranceNode per context name (ContextUtil.java:120 trueEnter caches
# into a static map + attaches to the global ROOT).
_lock = threading.RLock()
_entrance_nodes: Dict[str, EntranceNode] = {}
MAX_CONTEXT_NAME_SIZE = 2000  # Constants.MAX_CONTEXT_NAME_SIZE

_root: Optional[EntranceNode] = None


def root() -> EntranceNode:
    """The machine root every context's entrance node hangs from (the
    reference's ``ROOT``). Built at first use, not at import: its windows
    build the native library."""
    global _root
    if _root is None:
        with _lock:
            if _root is None:
                _root = EntranceNode(
                    ResourceWrapper("machine-root", EntryType.IN))
    return _root


def enter(name: str = CONTEXT_DEFAULT_NAME, origin: str = "") -> Context:
    """``ContextUtil.enter`` — bind a named context to the current task/thread."""
    ctx = _context_var.get()
    if ctx is not None:
        return ctx
    node = _entrance_nodes.get(name)
    if node is None:
        with _lock:
            node = _entrance_nodes.get(name)
            if node is None:
                if len(_entrance_nodes) >= MAX_CONTEXT_NAME_SIZE:
                    ctx = NullContext()
                    _context_var.set(ctx)
                    return ctx
                node = EntranceNode(ResourceWrapper(name, EntryType.IN))
                root().add_child(node)
                _entrance_nodes[name] = node
    ctx = Context(name, node, origin)
    _context_var.set(ctx)
    return ctx


def get_context() -> Optional[Context]:
    return _context_var.get()


def exit() -> None:
    """``ContextUtil.exit`` — drop the context if no entry is outstanding."""
    ctx = _context_var.get()
    if ctx is not None and ctx.cur_entry is None:
        _context_var.set(None)


def replace_context(ctx: Optional[Context]):
    """For async adapters: swap the bound context, returning the previous one
    (``ContextUtil.replaceContext``)."""
    prev = _context_var.get()
    _context_var.set(ctx)
    return prev


def reset_for_tests() -> None:
    with _lock:
        _entrance_nodes.clear()
        if _root is not None:
            _root.children.clear()
    _context_var.set(None)
