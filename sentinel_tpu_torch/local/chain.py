"""Processor slot chain: the interception pipeline (the port's copy of
``sentinel_tpu/local/chain.py``).

Analog of ``slotchain/ProcessorSlot.java:28`` (entry/fireEntry/exit/fireExit),
``DefaultProcessorSlotChain``, and the SPI-sorted ``DefaultSlotChainBuilder``
(``slots/DefaultSlotChainBuilder.java:37``). Slots register in the
``"slot"`` registry with their order constant; the chain is rebuilt per
resource from the sorted registry, so extensions (param-flow, gateway) insert
by registering a factory — same seam as the reference's ``META-INF/services``
file.
"""

from __future__ import annotations

from typing import List, Optional

from sentinel_tpu_torch.core import clock as _clock
from sentinel_tpu_torch.core.registry import registry
from sentinel_tpu_torch.local.base import (
    BlockException,
    EntryType,
    PriorityWaitException,
    ResourceWrapper,
)
from sentinel_tpu_torch.local.context import Context
from sentinel_tpu_torch.local.stat import ClusterNode, DefaultNode

slot_registry = registry("slot")


class ProcessorSlot:
    """A stage in the chain. ``entry`` runs checks/bookkeeping then must call
    ``fire_entry`` to continue; ``exit`` likewise with ``fire_exit``."""

    order: int = 0

    def __init__(self):
        self.next: Optional["ProcessorSlot"] = None

    # -- template ------------------------------------------------------------
    def entry(self, context: Context, resource: ResourceWrapper, node, count: int,
              prioritized: bool, args: tuple) -> None:
        self.fire_entry(context, resource, node, count, prioritized, args)

    def fire_entry(self, context: Context, resource: ResourceWrapper, node, count: int,
                   prioritized: bool, args: tuple) -> None:
        if self.next is not None:
            self.next.entry(context, resource, node, count, prioritized, args)

    def exit(self, context: Context, resource: ResourceWrapper, count: int,
             args: tuple) -> None:
        self.fire_exit(context, resource, count, args)

    def fire_exit(self, context: Context, resource: ResourceWrapper, count: int,
                  args: tuple) -> None:
        if self.next is not None:
            self.next.exit(context, resource, count, args)


class SlotChain:
    """Linked chain with a synthetic head (``DefaultProcessorSlotChain``)."""

    def __init__(self, slots: List[ProcessorSlot]):
        self.first: Optional[ProcessorSlot] = None
        tail: Optional[ProcessorSlot] = None
        for slot in slots:
            if self.first is None:
                self.first = tail = slot
            else:
                tail.next = slot  # type: ignore[union-attr]
                tail = slot

    def entry(self, context, resource, node, count, prioritized, args) -> None:
        if self.first is not None:
            self.first.entry(context, resource, node, count, prioritized, args)

    def exit(self, context, resource, count, args) -> None:
        if self.first is not None:
            self.first.exit(context, resource, count, args)


def build_chain() -> SlotChain:
    """Instantiate all registered slots, order-sorted (one fresh instance set
    per resource chain, as in the reference — slots hold per-chain state)."""
    return SlotChain(slot_registry.instances_sorted())


# ---------------------------------------------------------------------------
# Core slots
# ---------------------------------------------------------------------------


class NodeSelectorSlot(ProcessorSlot):
    """Builds the invocation tree: one DefaultNode per (resource, context
    name), cached per-chain (``slots/nodeselector/NodeSelectorSlot.java:128``).
    """

    def __init__(self):
        super().__init__()
        self._nodes = {}  # context name -> DefaultNode

    def entry(self, context, resource, node, count, prioritized, args):
        n = self._nodes.get(context.name)
        if n is None:
            n = self._nodes.setdefault(context.name, DefaultNode(resource))
            parent = context.cur_entry.parent_node() if context.cur_entry else None
            (parent or context.entrance_node).add_child(n)
        context.cur_entry.cur_node = n
        self.fire_entry(context, resource, n, count, prioritized, args)


_cluster_nodes = {}  # resource name -> ClusterNode (ClusterBuilderSlot.java:50)
import threading as _threading

_cluster_lock = _threading.RLock()


def get_cluster_node(resource_name: str) -> Optional[ClusterNode]:
    return _cluster_nodes.get(resource_name)


def cluster_node_map():
    return dict(_cluster_nodes)


def reset_cluster_nodes_for_tests():
    with _cluster_lock:
        _cluster_nodes.clear()


class ClusterBuilderSlot(ProcessorSlot):
    """One ClusterNode per resource + per-origin node selection
    (``slots/clusterbuilder/ClusterBuilderSlot.java:50-119``)."""

    def entry(self, context, resource, node, count, prioritized, args):
        cn = _cluster_nodes.get(resource.name)
        if cn is None:
            with _cluster_lock:
                cn = _cluster_nodes.get(resource.name)
                if cn is None:
                    cn = ClusterNode(resource.name)
                    _cluster_nodes[resource.name] = cn
        node.cluster_node = cn
        if context.origin:
            context.cur_entry.origin_node = cn.get_or_create_origin_node(
                context.origin
            )
        self.fire_entry(context, resource, node, count, prioritized, args)


class LogSlot(ProcessorSlot):
    """Logs block events (``slots/logger/LogSlot.java:32``). The reference's
    EagleEye block log aggregates per (resource, second); we throttle the same
    way — one line per resource per second with a suppressed-count."""

    _last_logged: dict = {}
    _suppressed: dict = {}

    def entry(self, context, resource, node, count, prioritized, args):
        try:
            self.fire_entry(context, resource, node, count, prioritized, args)
        except BlockException as e:
            from sentinel_tpu_torch.core import clock as _clock
            from sentinel_tpu_torch.core.log import record_log
            from sentinel_tpu_torch.metrics.stat_logger import log_block

            # aggregated block log (EagleEyeLogUtil.log analog): every block
            # lands in the rolling stat log keyed (resource, origin, rule)
            log_block(resource.name, context.origin, type(e).__name__)
            sec = _clock.now_ms() // 1000
            key = resource.name
            if LogSlot._last_logged.get(key) != sec:
                suppressed = LogSlot._suppressed.pop(key, 0)
                LogSlot._last_logged[key] = sec
                record_log.info(
                    "block: resource=%s context=%s origin=%s rule=%s suppressed=%d",
                    resource.name, context.name, context.origin,
                    type(e).__name__, suppressed,
                )
            else:
                LogSlot._suppressed[key] = LogSlot._suppressed.get(key, 0) + 1
            raise


_ext_module = None


def _extension_hooks():
    """Cached handle to ``metrics.extension`` — imported lazily because
    ``metrics.__init__`` → ``exporter`` imports this module back, but cached
    in a module global so the entry hot path pays a dict lookup, not an
    import-machinery round trip per call."""
    global _ext_module
    if _ext_module is None:
        from sentinel_tpu_torch.metrics import extension as _ext_mod

        _ext_module = _ext_mod
    return _ext_module


class StatisticSlot(ProcessorSlot):
    """The write path (``slots/statistic/StatisticSlot.java:52-153``):
    fire checks first; count pass/block/rt afterwards based on the outcome."""

    def entry(self, context, resource, node, count, prioritized, args):
        _ext = _extension_hooks()
        try:
            self.fire_entry(context, resource, node, count, prioritized, args)
        except PriorityWaitException:
            # borrowed a future window: concurrency counts, pass was pre-paid
            node.increase_thread()
            if node.cluster_node is not None:
                node.cluster_node.increase_thread()
            if context.cur_entry.origin_node is not None:
                context.cur_entry.origin_node.increase_thread()
            if resource.entry_type == EntryType.IN:
                _entry_node().increase_thread()
            # the borrow pre-paid the pass in the built-in counters, but
            # extension sinks still observe it as a pass (the reference
            # fires onPass in its PriorityWaitException catch too)
            _ext.on_pass(resource.name, count, args)
            _ext.on_thread_inc(resource.name, args)
        except BlockException as e:
            context.cur_entry.block_error = e
            now = _clock.now_ms()
            node.add_block(count, now=now)
            if node.cluster_node is not None:
                node.cluster_node.add_block(count, now=now)
            if context.cur_entry.origin_node is not None:
                context.cur_entry.origin_node.add_block(count, now=now)
            if resource.entry_type == EntryType.IN:
                _entry_node().add_block(count, now=now)
            _ext.on_block(resource.name, count, context.origin, e, args)
            raise
        else:
            now = _clock.now_ms()
            node.increase_thread()
            node.add_pass(count, now=now)
            if node.cluster_node is not None:
                node.cluster_node.increase_thread()
                node.cluster_node.add_pass(count, now=now)
            if context.cur_entry.origin_node is not None:
                context.cur_entry.origin_node.increase_thread()
                context.cur_entry.origin_node.add_pass(count, now=now)
            if resource.entry_type == EntryType.IN:
                en = _entry_node()
                en.increase_thread()
                en.add_pass(count, now=now)
            _ext.on_pass(resource.name, count, args)
            _ext.on_thread_inc(resource.name, args)

    def exit(self, context, resource, count, args):
        entry = context.cur_entry
        if entry is not None and entry.block_error is None:
            now = _clock.now_ms()
            rt = now - entry.create_ms
            node = entry.cur_node
            if node is not None:
                node.add_rt_and_success(rt, count, now=now)
                node.decrease_thread()
                if node.cluster_node is not None:
                    node.cluster_node.add_rt_and_success(rt, count, now=now)
                    node.cluster_node.decrease_thread()
            if entry.origin_node is not None:
                entry.origin_node.add_rt_and_success(rt, count, now=now)
                entry.origin_node.decrease_thread()
            if resource.entry_type == EntryType.IN:
                en = _entry_node()
                en.add_rt_and_success(rt, count, now=now)
                en.decrease_thread()
            _ext = _extension_hooks()
            _ext.on_complete(resource.name, count, rt, args)
            _ext.on_thread_dec(resource.name, args)
        self.fire_exit(context, resource, count, args)


# Global inbound-traffic node (Constants.ENTRY_NODE): target of the
# system-adaptive checks.
from sentinel_tpu_torch.local.base import TOTAL_IN_RESOURCE_NAME

_entry_node_singleton: Optional[ClusterNode] = None


def _entry_node() -> ClusterNode:
    global _entry_node_singleton
    if _entry_node_singleton is None:
        _entry_node_singleton = ClusterNode(TOTAL_IN_RESOURCE_NAME)
    return _entry_node_singleton


def entry_node() -> ClusterNode:
    return _entry_node()


def reset_entry_node_for_tests() -> None:
    global _entry_node_singleton
    _entry_node_singleton = None


# Register core slots (orders from Constants.java:76-83).
from sentinel_tpu_torch.local import base as _base

slot_registry.register(NodeSelectorSlot, order=_base.ORDER_NODE_SELECTOR_SLOT,
                       name="NodeSelectorSlot")
slot_registry.register(ClusterBuilderSlot, order=_base.ORDER_CLUSTER_BUILDER_SLOT,
                       name="ClusterBuilderSlot")
slot_registry.register(LogSlot, order=_base.ORDER_LOG_SLOT, name="LogSlot")
slot_registry.register(StatisticSlot, order=_base.ORDER_STATISTIC_SLOT,
                       name="StatisticSlot")
