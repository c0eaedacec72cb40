"""Mesh + sharding rules (L7 extension; SURVEY.md §2 parallelism table).

The reference's only parallelism is single-host nn.DataParallel
(train.py:75-78). The design here:

- mesh axes ("data", "point"): frame pairs sharded over "data" (gradient
  all-reduce inserted by XLA), the N-point axis of both clouds
  sharded over "point" — the point-cloud analogue of sequence parallelism
  (SURVEY.md §5 "long-context"): the [S, N] distance tiles and per-point
  MLPs partition over devices, with XLA inserting the all-gathers where an
  op needs the full point set (top-k, FPS).
- parameters and optimizer state are replicated (the model is < 100k
  params; there is nothing to gain from TP on the weights).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
POINT_AXIS = "point"


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None,
    data: Optional[int] = None,
    point: int = 1,
) -> Mesh:
    """A ("data", "point") mesh over the given (default: all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None:
        assert n % point == 0, (n, point)
        data = n // point
    assert data * point == n, (data, point, n)
    arr = np.asarray(devices).reshape(data, point)
    return Mesh(arr, (DATA_AXIS, POINT_AXIS))


def batch_pair_sharding(mesh: Mesh) -> Tuple[NamedSharding, ...]:
    """Shardings for a (src, tgt, R, t) batch: clouds sharded over
    (data, point); poses over data only."""
    cloud = NamedSharding(mesh, P(DATA_AXIS, POINT_AXIS, None))
    pose = NamedSharding(mesh, P(DATA_AXIS))
    return cloud, cloud, pose, pose


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, batch):
    """Device-put a host (src, tgt, R, t) batch with the pair shardings.

    Single-process: a plain device_put. Multi-process: `batch` is this
    HOST'S LOCAL shard (from data.batch_iterator(host_id=..,
    num_hosts=..)) and the global array is assembled with
    jax.make_array_from_process_local_data — numpy inputs cannot take
    cross-process shardings directly."""
    shardings = batch_pair_sharding(mesh)
    if jax.process_count() > 1:
        return tuple(
            jax.make_array_from_process_local_data(s, np.asarray(a))
            for a, s in zip(batch, shardings)
        )
    return tuple(
        jax.device_put(np.asarray(a), s) for a, s in zip(batch, shardings)
    )
