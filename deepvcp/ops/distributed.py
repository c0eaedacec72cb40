"""Distributed (multi-device) neighbor search: ring KNN.

The point-cloud analogue of ring attention (SURVEY.md §5 "long-context"):
for clouds too large for one device's memory, both the query and reference
points are sharded over the mesh's "point" axis. Each step, every device
computes exact KNN of its query shard against the reference shard it
currently holds, merges into a running top-k, and passes its reference
shard to the next device with `ppermute`. After P steps every query has
seen every reference point; peak memory is one [Q/P, N/P] distance tile
per device, and the shard exchange is a ppermute between neighbours on
the ring (NCCL on GPUs, where every card reaches every other).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from deepvcp.ops.distance import square_distance
from deepvcp.parallel.mesh import POINT_AXIS


def ring_knn(
    mesh: Mesh,
    ref: jax.Array,
    query: jax.Array,
    k: int,
    batch_axis: str = None,
) -> Tuple[jax.Array, jax.Array]:
    """Exact K-nearest-neighbors with both clouds sharded over the mesh's
    "point" axis.

    Args:
        ref: [B, N, 3] reference points (N divisible by the axis size).
        query: [B, M, 3] query points (M divisible likewise).
        k: neighbors per query (k <= N / axis_size).
        batch_axis: optional mesh axis the BATCH dim is sharded over
            (e.g. "data" when called from the model under the
            ("data", "point") training mesh, so the shard_map composes
            with the data-parallel batch sharding instead of forcing an
            all-gather over it; B must divide by that axis size).
    Returns:
        (dist [B, M, k] ascending euclidean distances,
         idx [B, M, k] int32 global indices into N) — identical to
        ops.knn (verified in tests on the CPU mesh).
    """
    n_dev = mesh.shape[POINT_AXIS]
    N = ref.shape[1]
    shard_n = N // n_dev
    assert shard_n * n_dev == N, (N, n_dev)
    assert k <= shard_n, (k, shard_n)
    if batch_axis is not None:
        assert ref.shape[0] % mesh.shape[batch_axis] == 0, (
            ref.shape, batch_axis, mesh.shape)
    spec = P(batch_axis, POINT_AXIS, None)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(spec, spec),
    )
    def run(ref_shard, query_shard):
        me = jax.lax.axis_index(POINT_AXIS)
        perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

        def step(carry, _):
            block, owner, best_d, best_i = carry
            # exact KNN of my queries against the block I currently hold
            d2 = square_distance(query_shard, block)     # [B, m, shard_n]
            neg, local = jax.lax.top_k(-d2, k)
            gidx = owner * shard_n + local.astype(jnp.int32)
            # merge with the running top-k
            cat_d = jnp.concatenate([best_d, -neg], axis=-1)
            cat_i = jnp.concatenate([best_i, gidx], axis=-1)
            neg2, sel = jax.lax.top_k(-cat_d, k)
            best_d = -neg2
            best_i = jnp.take_along_axis(cat_i, sel, axis=-1)
            # rotate the reference shard around the ring
            block = jax.lax.ppermute(block, POINT_AXIS, perm)
            owner = jax.lax.ppermute(owner, POINT_AXIS, perm)
            return (block, owner, best_d, best_i), None

        B, m, _ = query_shard.shape
        # mark the running top-k buffers as varying over the ring axis —
        # and the batch axis when sharded over one — so the scan carry
        # types match (the loop outputs are device-varying)
        vary_axes = (
            (POINT_AXIS,) if batch_axis is None else (POINT_AXIS, batch_axis)
        )

        def varying(x):
            return jax.lax.pcast(x, vary_axes, to="varying")
        init = (
            ref_shard,
            me,
            varying(jnp.full((B, m, k), jnp.inf, query_shard.dtype)),
            varying(jnp.zeros((B, m, k), jnp.int32)),
        )
        (block, owner, best_d, best_i), _ = jax.lax.scan(
            step, init, None, length=n_dev
        )
        return jnp.sqrt(jnp.maximum(best_d, 0.0)), best_i

    return run(ref, query)
