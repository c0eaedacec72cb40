"""Farthest-point sampling.

The reference's FPS (pointnet2_utils.py:63-84) is a Python loop of `npoint`
dependent argmax iterations. Here it is a `lax.fori_loop` so the whole
thing compiles to one device loop. Deterministic: starts from `start_idx`
(the reference starts from a random point, which makes the op
nondeterministic for no benefit —
the selected *set* differs only in which permutation of far points you get).

Note: in the reference pipeline FPS never actually subsamples (it is always
called with npoint == N, deep_feat_extraction.py:10-14 and deepVCP.py:54), so
the model path skips it; the op exists as a first-class library kernel for
npoint < N use.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def farthest_point_sample(
    xyz: jax.Array, npoint: int, start_idx: int = 0,
) -> jax.Array:
    """Iterative farthest-point sampling.

    Args:
        xyz: [B, N, 3]
        npoint: number of samples to draw (<= N).
    Returns:
        centroids: [B, npoint] int32 indices.
    """
    B, N, _ = xyz.shape

    def body(i, state):
        distance, farthest, centroids = state
        centroids = centroids.at[:, i].set(farthest)
        centroid = jnp.take_along_axis(xyz, farthest[:, None, None], axis=1)
        d = jnp.sum((xyz - centroid) ** 2, axis=-1)          # [B, N]
        distance = jnp.minimum(distance, d)
        farthest = jnp.argmax(distance, axis=-1).astype(jnp.int32)
        return distance, farthest, centroids

    init = (
        jnp.full((B, N), jnp.inf, dtype=xyz.dtype),
        jnp.full((B,), start_idx, dtype=jnp.int32),
        jnp.zeros((B, npoint), dtype=jnp.int32),
    )
    _, _, centroids = jax.lax.fori_loop(0, npoint, body, init)
    return centroids
