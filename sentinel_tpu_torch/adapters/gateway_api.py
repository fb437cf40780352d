"""Custom API groups for gateway flow control.

Analog of ``sentinel-api-gateway-adapter-common``'s API layer:

- ``ApiDefinition`` (``api/ApiDefinition.java``): a named group of path
  predicates — a "custom API" a gateway rule can target by name
  (``ResourceMode.CUSTOM_API_NAME``).
- ``ApiPathPredicateItem`` (``api/ApiPathPredicateItem.java``): one path
  pattern with a match strategy (``SentinelGatewayConstants.URL_MATCH_STRATEGY_
  {EXACT,PREFIX,REGEX}``).
- ``ApiPredicateGroupItem`` (``api/ApiPredicateGroupItem.java``): OR-group of
  sub-predicates.
- ``GatewayApiDefinitionManager`` (``api/GatewayApiDefinitionManager.java``):
  definition registry driven by a ``DynamicProperty`` (register a datasource
  property exactly like rule managers), fanning updates out to change
  observers (``ApiDefinitionChangeObserver`` analog).
- ``GatewayApiMatcherManager`` (``sentinel-spring-cloud-gateway-adapter/.../
  GatewayApiMatcherManager.java``): definition → compiled matcher;
  ``pick_matching_api_names(path)`` is what adapters call per request to map
  a path onto its custom API resources before entering the gateway slot.
"""

from __future__ import annotations

import enum
import re
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from sentinel_tpu_torch.core.log import record_log
from sentinel_tpu_torch.core.property import DynamicProperty


class UrlMatchStrategy(enum.IntEnum):
    """``SentinelGatewayConstants.URL_MATCH_STRATEGY_*``."""

    EXACT = 0
    PREFIX = 1
    REGEX = 2


@dataclass(frozen=True)
class ApiPathPredicateItem:
    """One path predicate (``ApiPathPredicateItem.java``)."""

    pattern: str
    match_strategy: UrlMatchStrategy = UrlMatchStrategy.EXACT

    def matches(self, path: str) -> bool:
        if self.match_strategy == UrlMatchStrategy.EXACT:
            return path == self.pattern
        if self.match_strategy == UrlMatchStrategy.PREFIX:
            return path.startswith(self.pattern)
        try:
            # full-path match like the reference (Zuul's Pattern.matches /
            # SCG's route predicate): an unanchored fragment must not pull
            # every path merely containing it under the API
            return re.fullmatch(self.pattern, path) is not None
        except re.error:
            return False


@dataclass(frozen=True)
class ApiPredicateGroupItem:
    """OR-group of predicates (``ApiPredicateGroupItem.java``)."""

    items: Tuple[ApiPathPredicateItem, ...] = ()

    def matches(self, path: str) -> bool:
        return any(item.matches(path) for item in self.items)


@dataclass(frozen=True)
class ApiDefinition:
    """A named custom API = OR of its predicates (``ApiDefinition.java``)."""

    api_name: str
    predicate_items: Tuple[object, ...] = ()  # path items and/or groups

    def matches(self, path: str) -> bool:
        return any(item.matches(path) for item in self.predicate_items)


def _is_valid(definition: ApiDefinition) -> bool:
    """``GatewayApiDefinitionManager.isValidApi``: a name and ≥1 predicate."""
    return bool(definition.api_name) and bool(definition.predicate_items)


class GatewayApiDefinitionManager:
    """Definition registry + change fan-out (class-level, like the rule
    managers — the reference's statics)."""

    _lock = threading.RLock()
    # serializes whole load→notify sequences: without it two concurrent
    # loads could deliver observer snapshots out of order, leaving matchers
    # permanently stale relative to the registry
    _load_lock = threading.Lock()
    _definitions: Dict[str, ApiDefinition] = {}
    _observers: List[Callable[[List[ApiDefinition]], None]] = []
    _property: Optional[DynamicProperty] = None
    _listener = None

    @classmethod
    def load_api_definitions(cls, definitions: Iterable[ApiDefinition]) -> None:
        with cls._load_lock:
            with cls._lock:
                valid = {}
                for d in definitions or ():
                    if _is_valid(d):
                        valid[d.api_name] = d
                    else:
                        record_log.warning(
                            "ignoring invalid api definition: %r", d
                        )
                cls._definitions = valid
                observers = list(cls._observers)
                snapshot = list(valid.values())
            for observer in observers:
                try:
                    observer(snapshot)
                except Exception:
                    record_log.exception("api definition observer failed")

    @classmethod
    def get_api_definition(cls, api_name: str) -> Optional[ApiDefinition]:
        with cls._lock:
            return cls._definitions.get(api_name)

    @classmethod
    def get_api_definitions(cls) -> List[ApiDefinition]:
        with cls._lock:
            return list(cls._definitions.values())

    @classmethod
    def add_observer(cls, observer: Callable[[List[ApiDefinition]], None]) -> None:
        """``ApiDefinitionChangeObserver`` analog; called with the full
        definition list on every load. Serialized with loads under
        ``_load_lock`` so the registration snapshot can't race a concurrent
        load and overwrite its (newer) delivery."""
        with cls._load_lock:
            with cls._lock:
                cls._observers.append(observer)
                snapshot = list(cls._definitions.values())
            observer(snapshot)

    @classmethod
    def register_property(cls, prop: DynamicProperty) -> None:
        """Drive definitions from a datasource-backed property
        (``register2Property``): the property's value is a list of
        ``ApiDefinition`` (or dicts in the same shape, as a datasource
        converter would produce)."""
        with cls._lock:
            if cls._property is not None and cls._listener is not None:
                cls._property.remove_listener(cls._listener)
            cls._property = prop
        # listen() takes the property's lock and fires the first load
        # synchronously — must happen OUTSIDE cls._lock or a concurrent
        # update_value (property lock → load → cls._lock) deadlocks against
        # us (cls._lock → property lock). Same discipline as the other rule
        # managers' register_property.
        listener = prop.listen(
            lambda value: cls.load_api_definitions(
                [parse_api_definition(v) for v in (value or [])]
            )
        )
        with cls._lock:
            cls._listener = listener

    @classmethod
    def reset_for_tests(cls) -> None:
        with cls._lock:
            if cls._property is not None and cls._listener is not None:
                cls._property.remove_listener(cls._listener)
            cls._definitions = {}
            cls._observers = []
            cls._property = None
            cls._listener = None


def parse_api_definition(obj) -> ApiDefinition:
    """Dict → ApiDefinition (datasource/command payload shape, matching the
    reference's JSON: apiName + predicateItems[{pattern, matchStrategy} |
    {items: [...]}])."""
    if isinstance(obj, ApiDefinition):
        return obj
    items = []
    for it in obj.get("predicateItems", obj.get("predicate_items", [])) or []:
        if "items" in it:
            items.append(
                ApiPredicateGroupItem(
                    tuple(
                        ApiPathPredicateItem(
                            sub["pattern"],
                            UrlMatchStrategy(
                                sub.get("matchStrategy",
                                        sub.get("match_strategy", 0))
                            ),
                        )
                        for sub in it["items"]
                    )
                )
            )
        else:
            items.append(
                ApiPathPredicateItem(
                    it["pattern"],
                    UrlMatchStrategy(
                        it.get("matchStrategy", it.get("match_strategy", 0))
                    ),
                )
            )
    return ApiDefinition(
        obj.get("apiName", obj.get("api_name", "")), tuple(items)
    )


def api_definition_to_dict(definition: ApiDefinition) -> dict:
    """ApiDefinition → JSON-shape dict (command/dashboard payloads)."""

    def item_to_dict(item):
        if isinstance(item, ApiPredicateGroupItem):
            return {"items": [item_to_dict(s) for s in item.items]}
        return {
            "pattern": item.pattern,
            "matchStrategy": int(item.match_strategy),
        }

    return {
        "apiName": definition.api_name,
        "predicateItems": [item_to_dict(i) for i in definition.predicate_items],
    }


class GatewayApiMatcherManager:
    """apiName → matcher, rebuilt on definition change
    (``GatewayApiMatcherManager.java`` — registered as a change observer).

    The "matcher" here is the definition itself (predicates are already
    compiled Python); what this manager adds is the per-request pick."""

    _lock = threading.RLock()
    _matchers: Dict[str, ApiDefinition] = {}
    _registered = False

    @classmethod
    def _ensure_registered(cls) -> None:
        with cls._lock:
            if not cls._registered:
                cls._registered = True
                GatewayApiDefinitionManager.add_observer(cls._on_change)

    @classmethod
    def _on_change(cls, definitions: List[ApiDefinition]) -> None:
        with cls._lock:
            cls._matchers = {d.api_name: d for d in definitions}

    @classmethod
    def pick_matching_api_names(cls, path: str) -> List[str]:
        """Every custom API whose predicates match the request path — the
        resources a gateway adapter enters IN ADDITION to the route
        (``pickMatchingApiDefinitions`` in the reference adapters)."""
        cls._ensure_registered()
        with cls._lock:
            matchers = list(cls._matchers.values())
        return [d.api_name for d in matchers if d.matches(path)]

    @classmethod
    def reset_for_tests(cls) -> None:
        with cls._lock:
            cls._matchers = {}
            cls._registered = False
