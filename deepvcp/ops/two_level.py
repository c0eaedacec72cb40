"""Two-level candidate-neighbor grouping — an alternative to the
reference's flat `knn_cuda` call (get_cat_feat_tgt.py:44-52).

The flat path builds a [K*C, N] = [13824, 10000] distance tile for the
selection plus a 442k-row random gather of [3+F]-channel neighbor rows.

Structure the flat path ignores: all C=216 candidates of one keypoint
sit in a +/-(search_radius + voxel_len/2) cube around the warm-started
keypoint, so their k-NN sets draw from ONE small neighborhood. Two
levels exploit that:

  1. keypoint level — top-T target rows per WARM KEYPOINT center
     (a [K, N] = [64, 10000] tile, 0.5% of the flat tile) and ONE
     gather of K*T = 32k rows (13x fewer rows than flat);
  2. candidate level — each candidate's k-NN selected WITHIN its
     keypoint's T-row table: distances are computed in keypoint-local
     coordinates (|values| <= table radius, so bf16 selection is safe
     even at KITTI-scale absolute coordinates — the flat path must
     select in f32 there, config.knn_select_f32_extent), and the final
     neighbor rows come from the table by take_along_axis.

Recall contract: a candidate's true k-NN is captured iff it lies within
the keypoint's top-T ball. With grid reach rho = sqrt(3) *
(search_radius + voxel_len/2) and local point density n per unit
volume, coverage needs T >= n * (4pi/3) * (rho + r_k)^3. At the bench
operating point (extent-20 uniform, T=512) that bound gives ~311; at
ModelNet scale (extent 2.5) the cube covers half the cloud and the
two-level structure cannot help — config gates on the extent/reach
ratio (DeepVCPConfig.use_two_level_tgt_knn). Measured recall lives in
tests/test_two_level.py and the round-5 campaign.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from deepvcp.ops.grouping import index_points
from deepvcp.ops.knn import approx_knn


def two_level_rows(
    tgt_xyz: jax.Array,
    rows: jax.Array,
    centers: jax.Array,
    cand: jax.Array,
    k: int,
    table_size: int = 512,
    recall_target: float = 0.95,
    select_dtype: Optional[str] = None,
    center_select_dtype: Optional[str] = None,
) -> jax.Array:
    """Neighbor rows for every candidate, via the two-level structure.

    Args:
        tgt_xyz: [B, N, 3] target cloud coordinates.
        rows: [B, N, D] the rows to gather per neighbor (xyz ++ features
            in the model; D arbitrary).
        centers: [B, K, 3] warm-started keypoint positions (the
            candidate cubes' centers).
        cand: [B, K, C, 3] candidate positions.
        k: neighbors per candidate.
        table_size: T, target rows kept per keypoint. Must cover the
            candidate cube plus the k-NN radius (see module docstring).
        recall_target: approx_min_k knob for the keypoint-level select.
        select_dtype: dtype for the candidate-level selection tile.
            Keypoint-LOCAL coordinates keep |values| small, so
            "bfloat16" is safe regardless of absolute cloud scale.
        center_select_dtype: dtype for the keypoint-level [K, N]
            selection tile (same caveats as ops.knn.approx_knn — use
            None/f32 at large absolute scales).
    Returns:
        [B, K, C, k, D] neighbor rows (ascending candidate distance).
    """
    B, K, C, _ = cand.shape
    N = tgt_xyz.shape[-2]
    T = min(table_size, N)

    # --- level 1: per-keypoint table -----------------------------------
    _, t_idx = approx_knn(
        tgt_xyz, centers, T,
        recall_target=recall_target, select_dtype=center_select_dtype,
    )                                                      # [B, K, T]
    table = index_points(rows, t_idx)                      # [B, K, T, D]
    table_xyz = table[..., :3]

    # --- level 2: candidate k-NN inside the table ----------------------
    # keypoint-local coordinates: distances are translation-invariant,
    # and locality bounds |coords| by the table radius, so a reduced
    # selection dtype loses only near-tie ordering (cf. the KITTI-scale
    # f32 gate the FLAT path needs, config.knn_select_f32_extent).
    local_t = table_xyz - centers[:, :, None, :]           # [B, K, T, 3]
    local_c = cand - centers[:, :, None, :]                # [B, K, C, 3]
    sel = jnp.dtype(select_dtype) if select_dtype else None
    if sel is not None:
        cross = jnp.einsum(
            "bkcd,bktd->bkct",
            local_c.astype(sel), local_t.astype(sel),
            preferred_element_type=jnp.float32,
        )
        d2 = (
            jnp.sum(jnp.square(local_c), axis=-1)[..., :, None]
            + jnp.sum(jnp.square(local_t), axis=-1)[..., None, :]
            - 2.0 * cross
        ).astype(sel)                                      # [B, K, C, T]
    else:
        d2 = (
            jnp.sum(jnp.square(local_c), axis=-1)[..., :, None]
            + jnp.sum(jnp.square(local_t), axis=-1)[..., None, :]
            - 2.0 * jnp.einsum("bkcd,bktd->bkct", local_c, local_t)
        )
    _, l_idx = jax.lax.approx_min_k(d2, k, recall_target=recall_target)
    l_idx = l_idx.astype(jnp.int32)                        # [B, K, C, k]

    # --- gather the winning table rows ---------------------------------
    flat_idx = l_idx.reshape(B, K, C * k, 1)
    out = jnp.take_along_axis(table, flat_idx, axis=-2)    # [B, K, C*k, D]
    return out.reshape(B, K, C, k, -1)
