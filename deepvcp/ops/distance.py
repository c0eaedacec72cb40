"""Pairwise squared-distance ops.

The NxM distance matrix is computed as one matmul plus two row/column
norms (the algebraic expansion the reference uses, pointnet2_utils.py:19-40),
and a chunked driver keeps the full [N, M] matrix from ever materializing
for large clouds.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def square_distance(src: jax.Array, dst: jax.Array) -> jax.Array:
    """Pairwise squared euclidean distances.

    Args:
        src: [..., N, C]
        dst: [..., M, C]
    Returns:
        [..., N, M] squared distances (clamped at 0 against fp cancellation).
    """
    s2 = jnp.sum(src * src, axis=-1)
    d2 = jnp.sum(dst * dst, axis=-1)
    # HIGHEST precision: the C=3 contraction is bandwidth-bound, and radius
    # thresholds downstream need f32-exact distances (reduced-precision passes would
    # misclassify boundary points).
    cross = jnp.einsum(
        "...nc,...mc->...nm",
        src,
        dst,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    dist = s2[..., :, None] + d2[..., None, :] - 2.0 * cross
    return jnp.maximum(dist, 0.0)


def map_query_chunks(
    fn: Callable[[jax.Array], jax.Array],
    queries: jax.Array,
    chunk: int,
    axis: int = -2,
) -> jax.Array:
    """Apply `fn` over blocks of the query axis to bound peak memory.

    `fn` maps [..., chunk, C] -> [..., chunk, ...out]; the query axis is padded
    to a multiple of `chunk` (static shapes for XLA) and the padding is
    stripped from the result. Used by ball-query and KNN so the [S, N]
    distance matrix only ever exists one tile at a time.
    """
    axis = axis % queries.ndim
    n = queries.shape[axis]
    if n <= chunk:
        return fn(queries)
    pad = (-n) % chunk
    if pad:
        widths = [(0, 0)] * queries.ndim
        widths[axis] = (0, pad)
        queries = jnp.pad(queries, widths, mode="edge")
    num_chunks = queries.shape[axis] // chunk
    # Move query axis to front of chunking: reshape axis -> (num_chunks, chunk)
    moved = jnp.moveaxis(queries, axis, 0)
    blocks = moved.reshape(num_chunks, chunk, *moved.shape[1:])

    def block_fn(block):
        # block: [chunk, ...rest]; restore original layout for fn
        return fn(jnp.moveaxis(block, 0, axis))

    out = jax.lax.map(block_fn, blocks)

    def unblock(o):
        # o: [num_chunks, ...] where fn's output keeps the chunk on `axis`.
        o = jnp.moveaxis(o, axis + 1, 1)  # [num_chunks, chunk, ...]
        o = o.reshape(num_chunks * chunk, *o.shape[2:])
        return jnp.moveaxis(o[:n], 0, axis)

    return jax.tree_util.tree_map(unblock, out)
