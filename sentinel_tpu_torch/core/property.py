"""Push-based dynamic configuration primitive (the port's copy of
``sentinel_tpu/core/property.py``).

Analog of ``sentinel-core/.../property/{SentinelProperty,DynamicSentinelProperty,
PropertyListener}.java``: rule managers subscribe a listener to a property; data
sources (file/polling/push) publish new values into it; ``update_value`` fans out
to listeners only when the value actually changed.
"""

from __future__ import annotations

import threading
from typing import Callable, Generic, List, Optional, TypeVar

T = TypeVar("T")


class PropertyListener(Generic[T]):
    def config_update(self, value: Optional[T]) -> None:
        raise NotImplementedError

    def config_load(self, value: Optional[T]) -> None:
        # reference: PropertyListener.configLoad — first-load callback
        self.config_update(value)


class FuncListener(PropertyListener[T]):
    def __init__(self, fn: Callable[[Optional[T]], None]):
        self._fn = fn

    def config_update(self, value: Optional[T]) -> None:
        self._fn(value)


class DynamicProperty(Generic[T]):
    """``DynamicSentinelProperty``: value holder + listener fan-out."""

    def __init__(self, value: Optional[T] = None):
        self._lock = threading.RLock()
        self._value: Optional[T] = value
        self._listeners: List[PropertyListener[T]] = []

    @property
    def value(self) -> Optional[T]:
        return self._value

    def add_listener(self, listener: PropertyListener[T]) -> None:
        with self._lock:
            self._listeners.append(listener)
            listener.config_load(self._value)

    def listen(self, fn: Callable[[Optional[T]], None]) -> PropertyListener[T]:
        lst = FuncListener(fn)
        self.add_listener(lst)
        return lst

    def remove_listener(self, listener: PropertyListener[T]) -> None:
        with self._lock:
            if listener in self._listeners:
                self._listeners.remove(listener)

    def update_value(self, value: Optional[T]) -> bool:
        """Publish; returns True if the value changed and listeners fired.

        reference: DynamicSentinelProperty.updateValue — no-op on equal value.

        Fan-out happens under the (re-entrant) lock so concurrent publishers
        cannot deliver values to listeners out of order — ``value`` and the
        listeners' view can never diverge. (The reference fires outside any
        lock and has this race; a ground-up redesign shouldn't.)
        """
        with self._lock:
            if self._value == value:
                return False
            self._value = value
            for lst in list(self._listeners):
                lst.config_update(value)
        return True
