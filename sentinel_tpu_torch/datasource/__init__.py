"""Dynamic rule datasources (analog of ``sentinel-extension/sentinel-datasource-*``).

``ReadableDataSource`` parses an external source into rules and publishes
them into a ``DynamicProperty`` that rule managers subscribe to;
``WritableDataSource`` persists rules pushed through the command center.
"""

from sentinel_tpu_torch.datasource.base import (
    Converter,
    ReadableDataSource,
    AutoRefreshDataSource,
    WritableDataSource,
    WritableDataSourceRegistry,
)
from sentinel_tpu_torch.datasource.file import (
    FileRefreshableDataSource,
    FileWritableDataSource,
)
from sentinel_tpu_torch.datasource.push_base import WatchingDataSource
from sentinel_tpu_torch.datasource.consul import ConsulDataSource
from sentinel_tpu_torch.datasource.etcd import EtcdDataSource
from sentinel_tpu_torch.datasource.nacos import NacosDataSource
from sentinel_tpu_torch.datasource.apollo import ApolloDataSource
from sentinel_tpu_torch.datasource.eureka import EurekaDataSource
from sentinel_tpu_torch.datasource.redis import RedisClient, RedisDataSource
from sentinel_tpu_torch.datasource.spring_cloud_config import (
    SpringCloudConfigDataSource,
)
from sentinel_tpu_torch.datasource.zookeeper import ZookeeperDataSource
from sentinel_tpu_torch.datasource.converters import (
    flow_rules_from_json,
    flow_rules_to_json,
    degrade_rules_from_json,
    degrade_rules_to_json,
    system_rules_from_json,
    system_rules_to_json,
    authority_rules_from_json,
    authority_rules_to_json,
    param_flow_rules_from_json,
    param_flow_rules_to_json,
)

__all__ = [
    "Converter",
    "ReadableDataSource",
    "AutoRefreshDataSource",
    "WritableDataSource",
    "WritableDataSourceRegistry",
    "FileRefreshableDataSource",
    "FileWritableDataSource",
    "WatchingDataSource",
    "ConsulDataSource",
    "EtcdDataSource",
    "NacosDataSource",
    "ApolloDataSource",
    "EurekaDataSource",
    "RedisClient",
    "RedisDataSource",
    "SpringCloudConfigDataSource",
    "ZookeeperDataSource",
    "flow_rules_from_json",
    "flow_rules_to_json",
    "degrade_rules_from_json",
    "degrade_rules_to_json",
    "system_rules_from_json",
    "system_rules_to_json",
    "authority_rules_from_json",
    "authority_rules_to_json",
    "param_flow_rules_from_json",
    "param_flow_rules_to_json",
]
