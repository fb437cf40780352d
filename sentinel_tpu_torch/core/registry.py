"""Ordered extension registry — the SPI mechanism (the port's copy of
``sentinel_tpu/core/registry.py``).

The reference glues every layer together with a classpath service loader
(``sentinel-core/.../spi/SpiLoader.java:73``) plus an ``@Spi(order=…, isDefault=…)``
annotation; slots, slot-chain builders, token services, command handlers and init
functions are all discovered this way.

Python needs no classpath scanning: the analog is a named registry with an
``@provides`` decorator carrying ``order`` / ``is_default``. Entry points are
explicit imports (importing ``sentinel_tpu_torch.local`` registers the default
slots), which keeps the
extension seam (register your own slot/handler/datasource) without the JVM
machinery.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Generic, List, Optional, Tuple, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """A named, order-sorted registry of factories (SpiLoader analog).

    ``loadInstanceListSorted()`` → :meth:`instances_sorted`;
    ``loadFirstInstanceOrDefault()`` → :meth:`first_or_default`.
    """

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.RLock()
        self._entries: List[Tuple[int, bool, str, Callable[[], T]]] = []

    def register(
        self,
        factory: Callable[[], T],
        *,
        order: int = 0,
        is_default: bool = False,
        name: Optional[str] = None,
    ) -> Callable[[], T]:
        with self._lock:
            self._entries.append(
                (order, is_default, name or getattr(factory, "__name__", "?"), factory)
            )
            self._entries.sort(key=lambda e: e[0])
        return factory

    def provides(self, *, order: int = 0, is_default: bool = False, name: Optional[str] = None):
        """Decorator form: ``@registry.provides(order=-7000)``."""

        def deco(factory: Callable[[], T]) -> Callable[[], T]:
            return self.register(factory, order=order, is_default=is_default, name=name)

        return deco

    def instances_sorted(self) -> List[T]:
        with self._lock:
            return [f() for _, _, _, f in self._entries]

    def first_or_default(self) -> Optional[T]:
        with self._lock:
            if not self._entries:
                return None
            for _, is_default, _, f in self._entries:
                if is_default:
                    return f()
            return self._entries[0][3]()

    def by_name(self, name: str) -> Optional[T]:
        with self._lock:
            for _, _, n, f in self._entries:
                if n == name:
                    return f()
        return None

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


_registries: Dict[str, Registry[Any]] = {}
_registries_lock = threading.Lock()


def registry(name: str) -> Registry[Any]:
    """Get or create the process-global registry for an extension point."""
    with _registries_lock:
        reg = _registries.get(name)
        if reg is None:
            reg = _registries[name] = Registry(name)
        return reg
