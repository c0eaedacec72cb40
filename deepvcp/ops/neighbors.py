"""Spatially-sorted windowed neighbor search — the sort-free engine behind
ball query and KNN at large N.

An exact top_k over each [S, N] row is sort-bound; this module replaces it
with dense, sort-free ops:

1.  Points are sorted once per cloud along one spatial axis (a single 1-D
    argsort, microseconds at N=10k). The order is reused by every query at
    every radius.
2.  For each query, the candidates within radius r all lie in the
    contiguous sorted-index slab [x_q - r, x_q + r]; its bounds come from a
    vectorized binary search (log2 N gathers, fully batched).
3.  A static-width window of W candidates is gathered from the slab and
    masked by true 3-D distance. W bounds the slab occupancy
    (N * 2r / extent on average); overflowing candidates are dropped
    (choose W generously; see `window_for`).
4.  Selection of the first-`nsample` in-radius neighbors is a cumsum over
    the window plus a batched binary search over the (monotone) cumsum —
    no sort, no top_k, no scatter anywhere.

This is the point-cloud analogue of a flash-attention-style streaming
kernel, expressed entirely in XLA-friendly dense ops (SURVEY.md §5
"long-context": the [S, N] matrix never materializes).

Replaces: pointnet2_utils.py:87-107 (ball query) and the knn_cuda
extension (get_cat_feat_tgt.py:44-52) on the hot path.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp



class SortedCloud(NamedTuple):
    """A cloud sorted along one spatial axis."""

    xyz: jax.Array        # [B, N, 3] sorted by xyz[..., axis]
    key: jax.Array        # [B, N] the sort coordinate (ascending)
    perm: jax.Array       # [B, N] sorted index -> original index
    axis: int


def sort_cloud(xyz: jax.Array, axis: int = 0) -> SortedCloud:
    """Sort points along coordinate `axis` (one cheap 1-D sort per cloud)."""
    key = xyz[..., axis]
    perm = jnp.argsort(key, axis=-1).astype(jnp.int32)
    xyz_sorted = jnp.take_along_axis(xyz, perm[..., None], axis=-2)
    return SortedCloud(
        xyz=xyz_sorted, key=xyz_sorted[..., axis], perm=perm, axis=axis
    )


def searchsorted_batched(sorted_vals: jax.Array, queries: jax.Array) -> jax.Array:
    """Vectorized lower_bound: for each query, the first index i with
    sorted_vals[..., i] >= query. Shapes: sorted_vals [B, N], queries
    [B, S] -> [B, S] int32 in [0, N]."""
    N = sorted_vals.shape[-1]
    nbits = max(int(N - 1).bit_length(), 1)
    lo = jnp.zeros(queries.shape, jnp.int32)
    hi = jnp.full(queries.shape, N, jnp.int32)

    def body(_, state):
        lo, hi = state
        mid = (lo + hi) // 2
        v = jnp.take_along_axis(sorted_vals, jnp.minimum(mid, N - 1), axis=-1)
        active = lo < hi  # freeze converged lanes (extra iterations would
        go_right = (v < queries) & active  # otherwise push lo past hi)
        return jnp.where(go_right, mid + 1, lo), jnp.where(
            go_right | ~active, hi, mid
        )

    lo, hi = jax.lax.fori_loop(0, nbits + 1, body, (lo, hi))
    return lo


def window_for(num_points: int, radius: float, extent: float,
               safety: float = 8.0, minimum: int = 128) -> int:
    """Heuristic static window width: safety * expected slab occupancy,
    rounded up to a multiple of 128.

    The expectation assumes roughly UNIFORM density along the sort axis;
    real LiDAR clouds have ~100x radial density variation, so validate the
    chosen window against the data with `slab_occupancy_stats` (the
    Registrar preflight does this automatically and suggests a safety
    factor)."""
    expected = num_points * min(2.0 * radius / max(extent, 1e-6), 1.0)
    w = max(int(expected * safety), minimum)
    w = -(-w // 128) * 128
    return min(w, num_points)


def slab_occupancy_stats(xyz, radius: float, axis: int = 0) -> dict:
    """Host-side audit of the static-window coverage assumption.

    For every point, the number of cloud points within `radius` along the
    sort axis (the slab the windowed/banded engines must cover). Returns
    {max, p99, mean} occupancy. A static window (window_for) under-covers
    whenever max > window: queries in over-dense slabs lose in-radius
    neighbors (windowed engine) or band candidates (XLA banded path; the
    Pallas banded kernel computes exact slab bounds and is immune).

    Accepts [N, 3] or [B, N, 3] numpy/jax arrays; pure numpy, O(N log N).
    """
    import numpy as np

    xyz = np.asarray(xyz)
    if xyz.ndim == 2:
        xyz = xyz[None]
    occs = []
    for b in range(xyz.shape[0]):
        key = np.sort(xyz[b, :, axis])
        lo = np.searchsorted(key, key - radius, side="left")
        hi = np.searchsorted(key, key + radius, side="right")
        occs.append(hi - lo)
    occ = np.concatenate(occs)
    return {
        "max": int(occ.max()),
        "p99": int(np.percentile(occ, 99)),
        "mean": float(occ.mean()),
    }


def _window_d2(
    cloud: SortedCloud, query_xyz: jax.Array, cand_idx: jax.Array
) -> jax.Array:
    """Squared distance of each window candidate to its query, via THREE
    per-coordinate [B, S, W] gathers instead of one [B, S, W, 3] gather.

    A gather output inherits the operand's minor dim; per-coordinate
    gathers keep W on the minor axis instead of a minor dim of 3, which
    tiled layouts pad."""
    B = cand_idx.shape[0]
    flat = cand_idx.reshape(B, -1)
    d2 = None
    for c in range(3):
        col = jnp.take_along_axis(cloud.xyz[..., c], flat, axis=-1)
        col = col.reshape(cand_idx.shape)                      # [B, S, W]
        dc = jnp.square(col - query_xyz[..., c][..., None])
        d2 = dc if d2 is None else d2 + dc
    return d2


def _window_candidates(
    cloud: SortedCloud, query_xyz: jax.Array, radius: float, window: int
) -> Tuple[jax.Array, jax.Array]:
    """Gather each query's candidate window from the sorted cloud.

    Returns (cand_idx [B, S, W] int32 sorted-order indices,
             in_radius [B, S, W] bool)."""
    N = cloud.key.shape[-1]
    qkey = query_xyz[..., cloud.axis]
    lo = searchsorted_batched(cloud.key, qkey - radius)        # [B, S]
    # clamp so the full window stays in range (keeps gathers in-bounds and
    # never loses candidates when lo is near N)
    lo = jnp.minimum(lo, jnp.maximum(N - window, 0))
    cand_idx = lo[..., None] + jnp.arange(window, dtype=jnp.int32)
    cand_idx = jnp.minimum(cand_idx, N - 1)                     # [B, S, W]
    in_radius = _window_d2(cloud, query_xyz, cand_idx) <= radius * radius
    return cand_idx, in_radius


def select_first_k(mask: jax.Array, k: int) -> Tuple[jax.Array, jax.Array]:
    """Positions of the first k True entries per row, via cumsum + batched
    binary search on the monotone cumsum (no sort / top_k / scatter).

    Args:
        mask: [..., W] bool.
    Returns:
        (pos [..., k] int32 positions into W — rows with fewer than k hits
         repeat their first hit; all-empty rows return 0 —,
         count [...] int32 number of hits).
    """
    W = mask.shape[-1]
    cum = jnp.cumsum(mask.astype(jnp.int32), axis=-1)          # [..., W]
    count = cum[..., -1]
    targets = jnp.arange(1, k + 1, dtype=jnp.int32)
    targets = jnp.broadcast_to(targets, mask.shape[:-1] + (k,))
    pos = searchsorted_batched(
        cum.reshape(-1, W), targets.reshape(-1, k)
    ).reshape(targets.shape)
    pos = jnp.minimum(pos, W - 1)
    first = pos[..., :1]
    pos = jnp.where(targets <= count[..., None], pos, first)
    return pos, count


def windowed_ball_query(
    cloud: SortedCloud,
    query_xyz: jax.Array,
    radius: float,
    nsample: int,
    window: int,
    return_count: bool = False,
):
    """Ball query against a sorted cloud; reference semantics on the window
    (first `nsample` in-radius points, pad with first hit —
    pointnet2_utils.py:87-107).

    Returns idx [B, S, nsample] int32 indices in SORTED order (use
    cloud.perm to map back to original order if needed); with return_count
    also count [B, S] int32 — 0 marks queries whose WINDOW held no in-radius
    point, whose gathered "neighbors" are therefore garbage and must be
    masked (this can happen even for self-queries when the local slab
    occupancy exceeds `window` on density-gradient clouds; see
    slab_occupancy / the Registrar preflight audit).
    """
    cand_idx, in_radius = _window_candidates(cloud, query_xyz, radius, window)
    pos, count = select_first_k(in_radius, nsample)
    idx = jnp.take_along_axis(cand_idx, pos, axis=-1)
    if return_count:
        return idx, count
    return idx


def windowed_knn(
    cloud: SortedCloud,
    query_xyz: jax.Array,
    k: int,
    window: int,
) -> Tuple[jax.Array, jax.Array]:
    """K nearest neighbors among the query's sorted window (near-exact when
    the window spans the true neighborhood; replaces the global-exact
    knn_cuda call at get_cat_feat_tgt.py:44-52).

    Returns (dist [B, S, k] ascending, idx [B, S, k] sorted-order indices).
    """
    N = cloud.key.shape[-1]
    qkey = query_xyz[..., cloud.axis]
    # center the window on the query's slab position
    center = searchsorted_batched(cloud.key, qkey)
    lo = jnp.clip(center - window // 2, 0, jnp.maximum(N - window, 0))
    cand_idx = lo[..., None] + jnp.arange(window, dtype=jnp.int32)
    cand_idx = jnp.minimum(cand_idx, N - 1)
    d2 = _window_d2(cloud, query_xyz, cand_idx)
    neg, pos = jax.lax.top_k(-d2, k)
    idx = jnp.take_along_axis(cand_idx, pos, axis=-1)
    return jnp.sqrt(jnp.maximum(-neg, 0.0)), idx
