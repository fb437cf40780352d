"""Dashboard: the out-of-process console (``sentinel-dashboard`` analog).

Pull-based, like the reference (SURVEY.md §1 L8): apps POST heartbeats to
``/registry/machine``; the ``MetricFetcher`` polls each healthy machine's
``/metric`` command endpoint and aggregates into an in-memory repository
(5-minute retention, ``InMemoryMetricsRepository.java:40-63``); rule CRUD is
proxied to the app's command center via ``ApiClient``
(``SentinelApiClient.java:93,384,416``). The web UI is one embedded HTML page
over the REST API (the reference ships an AngularJS app; the console's value
is the API, not the framework it renders with).

Port of ``sentinel_tpu/dashboard``: host code, behaviour as the
reference's. A token server the console assigns (``cluster/assign``) is
built by the promoted machine's command center, on the card unless that
command center was given a ``server_factory``; a promotion that fails there
shows in the console's answer (``api_client.CommandFailed``).
"""

from sentinel_tpu_torch.dashboard.discovery import AppManagement, MachineInfo
from sentinel_tpu_torch.dashboard.repository import InMemoryMetricsRepository, MetricEntry
from sentinel_tpu_torch.dashboard.api_client import ApiClient
from sentinel_tpu_torch.dashboard.fetcher import MetricFetcher
from sentinel_tpu_torch.dashboard.server import DashboardServer
from sentinel_tpu_torch.dashboard.dynamic_rules import (
    ApiRuleProvider,
    ApiRulePublisher,
    DynamicRuleProvider,
    DynamicRulePublisher,
    FileRuleStore,
    StoreRuleProvider,
    StoreRulePublisher,
)

__all__ = [
    "AppManagement",
    "MachineInfo",
    "InMemoryMetricsRepository",
    "MetricEntry",
    "ApiClient",
    "MetricFetcher",
    "DashboardServer",
    "DynamicRuleProvider",
    "DynamicRulePublisher",
    "ApiRuleProvider",
    "ApiRulePublisher",
    "StoreRuleProvider",
    "StoreRulePublisher",
    "FileRuleStore",
]
