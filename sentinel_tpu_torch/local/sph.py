"""Entry path and public guard API (the port's copy of
``sentinel_tpu/local/sph.py``).

Analog of ``CtSph.java:43`` (per-resource chain cache, ``entryWithPriority``
at ``CtSph.java:117-158``), ``CtEntry.java:35`` (parent/child linking and
ordered exit), ``SphU``/``SphO`` and ``Tracer.java:31``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.local import context as ctx_mod
from sentinel_tpu_torch.local.base import (
    BlockException,
    EntryType,
    MAX_SLOT_CHAIN_SIZE,
    ResourceWrapper,
)
from sentinel_tpu_torch.local.chain import SlotChain, build_chain
from sentinel_tpu_torch.local.context import Context, NullContext


class Entry:
    """A live guarded invocation (``CtEntry``). Usable as a context manager;
    business exceptions raised inside the ``with`` are traced automatically
    (the reference requires an explicit ``Tracer.trace`` call)."""

    __slots__ = (
        "resource", "context", "chain", "create_ms", "completed_ms",
        "cur_node", "origin_node", "block_error", "error", "parent", "child",
        "count", "args", "_exited", "param_holds",
    )

    def __init__(self, resource: ResourceWrapper, chain: Optional[SlotChain],
                 context: Context, count: int, args: tuple):
        self.resource = resource
        self.context = context
        self.chain = chain
        self.count = count
        self.args = args
        self.create_ms = _clock.now_ms()
        self.completed_ms: Optional[int] = None
        self.cur_node = None
        self.origin_node = None
        self.block_error: Optional[BlockException] = None
        self.error: Optional[BaseException] = None
        self.param_holds = None
        self._exited = False
        # link into the context's entry stack (CtEntry.java:57-59)
        self.parent = context.cur_entry
        self.child = None
        if self.parent is not None:
            self.parent.child = self
        context.cur_entry = self

    def parent_node(self):
        return self.parent.cur_node if self.parent is not None else None

    def trace(self, error: BaseException, count: int = 1) -> None:
        """Record a business exception (``Tracer.traceEntry``)."""
        if self.error is not None or isinstance(error, BlockException):
            return
        self.error = error
        node = self.cur_node
        if node is not None:
            node.add_exception(count)
            if node.cluster_node is not None:
                node.cluster_node.add_exception(count)
        if self.origin_node is not None:
            self.origin_node.add_exception(count)
        from sentinel_tpu_torch.metrics import extension as _ext

        _ext.on_exception(self.resource.name, count, error)

    def exit(self, count: int = 1) -> None:
        if self._exited:
            return
        ctx = self.context
        if ctx.cur_entry is not self:
            # out-of-order exit: unwind children first (CtEntry.exitForContext
            # throws ErrorEntryFreeException; we repair instead, exiting the
            # stack down to self — strictly more forgiving, same invariant)
            e = ctx.cur_entry
            while e is not None and e is not self:
                nxt = e.parent
                e.exit(e.count)
                e = nxt
            if ctx.cur_entry is not self:
                self._exited = True
                return
        self._exited = True
        self.completed_ms = _clock.now_ms()
        if self.chain is not None:
            self.chain.exit(ctx, self.resource, count, self.args)
        ctx.cur_entry = self.parent
        if self.parent is not None:
            self.parent.child = None
        # Clear the ambient context only when this thread/task actually holds
        # it — a detached (async) entry may complete on a foreign thread whose
        # own context must not be torn down.
        if (
            ctx.cur_entry is None
            and not isinstance(ctx, NullContext)
            and ctx_mod.get_context() is ctx
        ):
            ctx_mod.exit()

    # -- context manager -----------------------------------------------------
    def __enter__(self) -> "Entry":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None and not isinstance(exc, BlockException):
            self.trace(exc)
        self.exit(self.count)
        return False


# Global kill switch (Constants.ON analog, toggled by the reference's
# setSwitch/getSwitch commands): when off, every entry passes through
# unguarded and uncounted.
_enabled = True


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def is_enabled() -> bool:
    return _enabled


class Sph:
    """``CtSph``: chain cache + the entry path."""

    def __init__(self):
        self._lock = threading.RLock()
        self._chains: Dict[ResourceWrapper, SlotChain] = {}
        # wrapper cache: frozen-dataclass construction (object.__setattr__
        # per field) costs ~1µs on the entry hot path and identity is by
        # name anyway. Bounded like the chain cache; beyond the cap a fresh
        # wrapper still works (it just isn't cached).
        self._wrappers: Dict[tuple, ResourceWrapper] = {}

    def _lookup_chain(self, resource: ResourceWrapper) -> Optional[SlotChain]:
        chain = self._chains.get(resource)
        if chain is None:
            with self._lock:
                chain = self._chains.get(resource)
                if chain is None:
                    # CtSph.java:136-144: beyond the cap, guard nothing.
                    if len(self._chains) >= MAX_SLOT_CHAIN_SIZE:
                        return None
                    chain = build_chain()
                    self._chains[resource] = chain
        return chain

    def entry(
        self,
        name: str,
        entry_type: EntryType = EntryType.OUT,
        count: int = 1,
        args: tuple = (),
        prioritized: bool = False,
    ) -> Entry:
        """``entryWithPriority`` (``CtSph.java:117-158``). Raises
        ``BlockException`` on a block verdict."""
        key = (name, entry_type)
        resource = self._wrappers.get(key)
        if resource is None:
            resource = ResourceWrapper(name, entry_type)
            if len(self._wrappers) < MAX_SLOT_CHAIN_SIZE * 2:
                self._wrappers[key] = resource
        ctx = ctx_mod.get_context()
        if not _enabled:
            # global switch off (CtSph.entryWithPriority's Constants.ON
            # check): pass-through, no stats, no rules
            return Entry(resource, None, ctx or NullContext(), count, args)
        if isinstance(ctx, NullContext):
            return Entry(resource, None, ctx, count, args)
        if ctx is None:
            ctx = ctx_mod.enter()
        chain = self._lookup_chain(resource)
        if chain is None:
            return Entry(resource, None, ctx, count, args)
        e = Entry(resource, chain, ctx, count, args)
        try:
            # PriorityWaitException never reaches here: StatisticSlot (always
            # ahead of FlowSlot) absorbs it and the entry proceeds as a pass.
            chain.entry(ctx, resource, None, count, prioritized, args)
        except BlockException:
            e.exit(count)
            raise
        return e

    def reset_for_tests(self) -> None:
        with self._lock:
            self._chains.clear()
            self._wrappers.clear()


_sph = Sph()


def sph() -> Sph:
    return _sph


def entry(
    name: str,
    entry_type: EntryType = EntryType.OUT,
    count: int = 1,
    args: tuple = (),
    prioritized: bool = False,
) -> Entry:
    """Guard a resource (``SphU.entry``). Use as a context manager::

        try:
            with sentinel.entry("getUser") as e:
                do_work()
        except BlockException:
            fallback()
    """
    return _sph.entry(name, entry_type, count, args, prioritized)


def async_entry(
    name: str,
    entry_type: EntryType = EntryType.OUT,
    count: int = 1,
    args: tuple = (),
    prioritized: bool = False,
) -> Entry:
    """Guard an operation whose completion happens elsewhere — another
    thread, a done-callback, or a different asyncio task
    (``SphU.asyncEntry`` / ``AsyncEntry.java`` analog).

    The verdict is taken against the caller's context as usual, then the
    entry is detached into a private context snapshot: the caller's entry
    stack is restored immediately, and ``exit()``/``trace()`` may be called
    from any thread without corrupting concurrent entries. Statistics
    (RT, concurrency, exceptions) still cover the real operation duration.
    """
    e = _sph.entry(name, entry_type, count, args, prioritized)
    ctx = e.context
    if isinstance(ctx, NullContext):
        return e
    async_ctx = Context(ctx.name, ctx.entrance_node, ctx.origin)
    async_ctx.async_mode = True
    async_ctx.cur_entry = e
    # pop from the caller's stack (AsyncEntry.cleanCurrentEntryInLocal)
    ctx.cur_entry = e.parent
    if e.parent is not None:
        e.parent.child = None
    e.parent = None
    e.context = async_ctx
    # the caller's context is left in place (AsyncEntry.cleanCurrentEntryInLocal
    # only pops the entry) — a later sync entry's exit clears an empty one
    return e


def try_entry(name: str, entry_type: EntryType = EntryType.OUT, count: int = 1,
              args: tuple = ()) -> Optional[Entry]:
    """Boolean-style variant (``SphO``): returns None instead of raising."""
    try:
        return _sph.entry(name, entry_type, count, args)
    except BlockException:
        return None


def trace(error: BaseException, count: int = 1) -> None:
    """``Tracer.trace``: record a business exception on the current entry."""
    ctx = ctx_mod.get_context()
    if ctx is not None and ctx.cur_entry is not None:
        ctx.cur_entry.trace(error, count)
