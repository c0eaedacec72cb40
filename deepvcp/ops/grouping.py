"""Point gathering and ball-query grouping.

Capability parity with the reference's `index_points` / `query_ball_point` /
`sample_and_group` (pointnet2_utils.py:43-138), designed for XLA:

- gathers are `jnp.take_along_axis` (no batch-index scaffolding, natively
  batched — the reference's arange/repeat pattern is its B=1 lock-in, D1);
- ball query selects the `nsample` lowest-index in-radius neighbors with a
  masked `top_k` instead of a full sort of the N axis;
- a chunked driver bounds the [S, N] distance tile.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from deepvcp.ops.distance import map_query_chunks, square_distance


def pc_normalize(pc: jax.Array) -> jax.Array:
    """Center a cloud and scale to the unit sphere
    (ref pointnet2_utils.py:11-17). pc [..., N, 3] -> same shape."""
    centroid = jnp.mean(pc, axis=-2, keepdims=True)
    pc = pc - centroid
    m = jnp.max(jnp.linalg.norm(pc, axis=-1), axis=-1)
    return pc / (m[..., None, None] + 1e-12)


def group_all(
    xyz: jax.Array, features: Optional[jax.Array] = None
) -> Tuple[jax.Array, jax.Array]:
    """Single all-points group centered at the origin
    (ref pointnet2_utils.py:141-158, the group_all SA variant).

    Returns (new_xyz [B, 1, 3] zeros, grouped [B, 1, N, 3+D])."""
    B, N, C = xyz.shape
    new_xyz = jnp.zeros((B, 1, C), xyz.dtype)
    grouped = xyz[:, None, :, :]
    if features is not None:
        grouped = jnp.concatenate(
            [grouped, features[:, None, :, :]], axis=-1
        )
    return new_xyz, grouped


def index_points(points: jax.Array, idx: jax.Array) -> jax.Array:
    """Gather points by index, batched.

    Args:
        points: [B, N, C]
        idx: [B, ...] integer indices into the N axis.
    Returns:
        [B, *idx.shape[1:], C]

    Reference: pointnet2_utils.py:43-60.
    """
    B, _, C = points.shape
    flat = idx.reshape(B, -1)
    out = jnp.take_along_axis(points, flat[..., None], axis=1)
    return out.reshape(*idx.shape, C)


def query_ball_point(
    radius: float,
    nsample: int,
    xyz: jax.Array,
    new_xyz: jax.Array,
    chunk: Optional[int] = None,
    return_count: bool = False,
):
    """Indices of up to `nsample` points of `xyz` within `radius` of each query.

    Matches the reference semantics (pointnet2_utils.py:87-107): neighbors are
    the `nsample` *lowest-index* in-radius points; queries with fewer than
    `nsample` hits repeat their first hit.

    Args:
        xyz: [B, N, 3] support points.
        new_xyz: [B, S, 3] query points.
        chunk: optional query-block size for memory tiling.
        return_count: also return the per-query in-radius hit count, so
            callers can mask zero-hit rows — the gathered "neighbors" of an
            empty query are an arbitrary clamped index (the reference
            crashes instead, pointnet2_utils.py:100-106); unmasked they
            pollute pooled features with a far point's geometry (review
            finding).
    Returns:
        idx [B, S, nsample] int32, and with return_count also
        count [B, S] int32 (min(total in-radius hits, nsample) per query;
        0 marks rows whose gathers are garbage).
    """
    N = xyz.shape[-2]

    def run(queries):
        sqr = square_distance(queries, xyz)  # [B, s, N]
        in_range = sqr <= radius * radius
        cand = jnp.where(in_range, jnp.arange(N, dtype=jnp.int32), jnp.int32(N))
        # top_k of the negated indices = nsample smallest indices, ascending.
        neg, _ = jax.lax.top_k(-cand, nsample)
        group_idx = -neg
        first = group_idx[..., :1]
        count = jnp.sum(
            (group_idx != N).astype(jnp.int32), axis=-1
        )                                               # [B, s]
        group_idx = jnp.where(group_idx == N, first, group_idx)
        # A query with zero in-radius hits keeps index N; clamp for safe gather
        # (the reference crashes in this case).
        idx = jnp.minimum(group_idx, N - 1)
        return (idx, count) if return_count else idx

    if chunk is None:
        return run(new_xyz)
    return map_query_chunks(run, new_xyz, chunk)


def sample_and_group(
    npoint: int,
    radius: float,
    nsample: int,
    xyz: jax.Array,
    features: Optional[jax.Array] = None,
    chunk: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """FPS-sample npoint centroids, then ball-query group (the reference's
    `sample_and_group`, pointnet2_utils.py:110-138; npoint == N skips the
    FPS permutation).

    Returns (new_xyz [B, npoint, 3], grouped [B, npoint, nsample, 3+D],
    idx [B, npoint, nsample])."""
    from deepvcp.ops.sampling import farthest_point_sample

    if npoint == xyz.shape[1]:
        new_xyz = xyz
    else:
        fps_idx = farthest_point_sample(xyz, npoint)
        new_xyz = index_points(xyz, fps_idx)
    grouped, _, idx = group_neighbors(
        radius, nsample, xyz, new_xyz, features, chunk=chunk
    )
    return new_xyz, grouped, idx


def group_neighbors(
    radius: float,
    nsample: int,
    xyz: jax.Array,
    new_xyz: jax.Array,
    features: Optional[jax.Array] = None,
    chunk: Optional[int] = None,
    return_count: bool = False,
):
    """Ball-query + gather + recenter (the core of `sample_and_group`).

    Zero-hit queries (no point of `xyz` within `radius`) are MASKED: their
    grouped rows are zeroed instead of carrying an arbitrary clamped
    point's geometry into the pooled features (the reference crashes on
    this case, pointnet2_utils.py:100-106; round-1/2 review finding). Rows
    with >= 1 hit keep reference semantics (pad with the first hit). Note
    every SA/keypoint call site queries points of the cloud itself, so the
    self point guarantees count >= 1 there — the mask is the safety net
    for foreign query points.

    Args:
        xyz: [B, N, 3]; new_xyz: [B, S, 3] centroids.
        features: optional [B, N, D] per-point features to gather alongside.
    Returns:
        (grouped [B, S, nsample, 3+D] with local xyz first,
         grouped_xyz_local [B, S, nsample, 3],
         idx [B, S, nsample])
        and, with return_count, also count [B, S] int32 so callers can mask
        downstream gathers of their own (e.g. nb_feat in models/deepvcp.py).

    Reference: pointnet2_utils.py:110-138 (minus the FPS step, which is done
    by the caller — see sampling.py; at npoint == N FPS is a permutation and
    is skipped entirely, see models/layers.py).
    """
    idx, count = query_ball_point(
        radius, nsample, xyz, new_xyz, chunk=chunk, return_count=True
    )
    ok = (count > 0)[..., None, None]                          # [B,S,1,1]
    grouped_xyz = index_points(xyz, idx)                       # [B,S,ns,3]
    grouped_xyz_local = jnp.where(
        ok, grouped_xyz - new_xyz[..., :, None, :], 0.0
    )
    if features is not None:
        grouped_feat = jnp.where(
            ok, index_points(features, idx), 0.0
        )                                                      # [B,S,ns,D]
        grouped = jnp.concatenate([grouped_xyz_local, grouped_feat], axis=-1)
    else:
        grouped = grouped_xyz_local
    if return_count:
        return grouped, grouped_xyz_local, idx, count
    return grouped, grouped_xyz_local, idx
