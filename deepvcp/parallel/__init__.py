from deepvcp.parallel.mesh import (
    DATA_AXIS,
    POINT_AXIS,
    batch_pair_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
from deepvcp.parallel.heartbeat import (
    Heartbeat,
    PeerFailure,
    Watchdog,
    check_peers,
    wait_for_all_hosts,
)
from deepvcp.parallel.multihost import (
    host_shard_info,
    initialize_multihost,
    is_primary_host,
)

__all__ = [
    "DATA_AXIS",
    "POINT_AXIS",
    "make_mesh",
    "batch_pair_sharding",
    "replicated",
    "shard_batch",
    "initialize_multihost",
    "Heartbeat",
    "Watchdog",
    "PeerFailure",
    "check_peers",
    "wait_for_all_hosts",
    "host_shard_info",
    "is_primary_host",
]
