"""Sharding: logical-axis rules, the ambient rule context and the port's
meshes (``repro.dist``).

``sharding`` holds the rule machinery (:class:`ShardingRules`,
:func:`default_rules`, :func:`divisible_spec`), ``context`` the ambient
install / query hooks, ``compat`` the partition spec and the placement,
SPMD and abstract meshes.  Importing this package touches no device and
no process group.
"""
from repro_torch.dist.context import current_rules, install_rules, maybe_shard
from repro_torch.dist.sharding import (ShardingRules, default_rules,
                                       divisible_spec,
                                       replicated_serving_rules,
                                       serving_shard_devices,
                                       sharded_serving_rules)

__all__ = [
    "ShardingRules", "default_rules", "divisible_spec",
    "replicated_serving_rules", "sharded_serving_rules",
    "serving_shard_devices", "current_rules", "install_rules",
    "maybe_shard",
]
