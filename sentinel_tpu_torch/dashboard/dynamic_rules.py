"""Pluggable rule providers/publishers — the v2 console contract.

Analog of the reference's ``DynamicRuleProvider.java:22`` (``getRules``)
and ``DynamicRulePublisher.java:22`` (``publish``), the seam behind
``controller/v2/FlowControllerV2.java:63-64``: the v1 console talks to app
machines directly (fetch from one, push to all), while v2 decouples the
console from the fleet through a configuration store — the publisher
WRITES the app's authoritative rule list to the store, the provider READS
it back, and the agents converge by watching the same store through their
datasource layer (``sentinel_tpu_torch.datasource.*``), never receiving a direct
dashboard push.

Python idiom: providers/publishers are small objects (or callables) wired
per ``(rule_type)`` into ``DashboardServer(rule_plugins=...)``; the
``ApiRule*`` pair reproduces v1's direct-to-machine behavior as a plugin so
both models ride one route, and ``FileRuleStore`` gives the store-backed
pair a zero-dependency backend whose files pair with each agent's
``FileRefreshableDataSource`` watcher.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Callable, Optional


class DynamicRuleProvider:
    """Reads the authoritative rule list for an app from somewhere."""

    def get_rules(self, app: str) -> Optional[list]:
        raise NotImplementedError


class DynamicRulePublisher:
    """Writes the authoritative rule list for an app to somewhere."""

    def publish(self, app: str, rules: list) -> None:
        raise NotImplementedError


# --------------------------------------------------------------------------
# Direct-to-machine pair (v1 behavior as a v2 plugin):
# FlowRuleApiProvider / FlowRuleApiPublisher analogs
# --------------------------------------------------------------------------


class ApiRuleProvider(DynamicRuleProvider):
    def __init__(self, apps, client, rule_type: str):
        self.apps = apps
        self.client = client
        self.rule_type = rule_type

    def get_rules(self, app: str) -> Optional[list]:
        machines = self.apps.healthy_machines(app)
        if not machines:
            return None
        return self.client.fetch_rules(machines[0], self.rule_type)


class ApiRulePublisher(DynamicRulePublisher):
    def __init__(self, apps, client, rule_type: str):
        self.apps = apps
        self.client = client
        self.rule_type = rule_type

    def publish(self, app: str, rules: list) -> None:
        machines = self.apps.healthy_machines(app)
        if not machines:
            raise RuntimeError(f"no healthy machine for app {app}")
        pushed = sum(
            self.client.push_rules(m, self.rule_type, rules)
            for m in machines
        )
        if pushed == 0:
            raise RuntimeError("push failed on every machine")


# --------------------------------------------------------------------------
# Store-backed pair (config-center model): the store is any get/set pair,
# so the same classes bind to etcd/nacos/redis via their client callables
# --------------------------------------------------------------------------


class StoreRuleProvider(DynamicRuleProvider):
    """``get(key) -> str | None`` + a key template → provider."""

    def __init__(self, get: Callable[[str], Optional[str]],
                 rule_type: str, key_fmt: str = "{app}-{type}-rules"):
        self.get = get
        self.rule_type = rule_type
        self.key_fmt = key_fmt

    def get_rules(self, app: str) -> Optional[list]:
        raw = self.get(self.key_fmt.format(app=app, type=self.rule_type))
        if raw is None:
            return []  # nothing published yet — an empty authoritative list
        rules = json.loads(raw)
        return rules if isinstance(rules, list) else []


class StoreRulePublisher(DynamicRulePublisher):
    """``set(key, value_str)`` + a key template → publisher."""

    def __init__(self, set_: Callable[[str, str], None],
                 rule_type: str, key_fmt: str = "{app}-{type}-rules"):
        self.set = set_
        self.rule_type = rule_type
        self.key_fmt = key_fmt

    def publish(self, app: str, rules: list) -> None:
        self.set(
            self.key_fmt.format(app=app, type=self.rule_type),
            json.dumps(rules),
        )


class FileRuleStore:
    """Directory-of-JSON-files store: key → ``<dir>/<key>.json``.

    The written path is exactly what an agent hands to its
    ``FileRefreshableDataSource`` (datasource/file.py), so publishing from
    the dashboard and converging on the agent share one file with no
    dashboard→machine connection. Writes are atomic (tmp + rename), the
    same torn-read guard as ``FileWritableDataSource``.
    """

    def __init__(self, root: str):
        self.root = root
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)

    def path_for(self, key: str) -> str:
        # keys embed app names, which arrive from heartbeats — never let
        # one traverse out of the store directory
        return os.path.join(self.root, re.sub(r"[^\w.-]", "_", key) + ".json")

    def get(self, key: str) -> Optional[str]:
        try:
            with open(self.path_for(key), "r", encoding="utf-8") as f:
                return f.read()
        except OSError:
            return None

    def set(self, key: str, value: str) -> None:
        path = self.path_for(key)
        with self._lock:
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(value)
            os.replace(tmp, path)

    def provider(self, rule_type: str) -> StoreRuleProvider:
        return StoreRuleProvider(self.get, rule_type)

    def publisher(self, rule_type: str) -> StoreRulePublisher:
        return StoreRulePublisher(self.set, rule_type)

    def plugins(self, rule_types) -> dict:
        """``rule_plugins`` mapping for DashboardServer: every type backed
        by this store."""
        return {
            t: (self.provider(t), self.publisher(t)) for t in rule_types
        }
