"""DeepVCP model assembly (L3 replacement; ref deepVCP.py:16-110).

One batched, jittable forward pass:

    FE(src) -> saliency top-K keypoints -> keypoint grouping + feature
    normalization -> FE(tgt) (shared weights) -> warm-start transform ->
    voxel candidate grid -> candidate KNN grouping + feature normalization ->
    shared DFE -> CPG cost volume -> softmax VCPs

Reference defects fixed here (SURVEY.md §2.12 "Known defects"):
    D1  natively batched (no flattened top-k indices);
    D3  t_init is applied along with R_init (deepVCP.py:86-92 drops it);
    D8  keypoint-neighbor features are gathered from the keypoints' own
        features (deepVCP.py:62 indexes the full cloud's features with
        keypoint-local indices);
    D9  candidate-KNN feature weights are per-neighbor d_j/sum(d)
        (get_cat_feat_tgt.py:65 broadcasts distances across the channel
        axis instead);
    D12 the candidate grid is centered (cfg.centered_grid; the reference's
        grid averages to -s/2 per axis, voxelize.py:62-71, biasing the
        softmax-centroid VCP by ~0.35 at the defaults);
    D13 source DFE neighborhoods come from the full source cloud
        (cfg.dfe_src_neighbors="cloud"), symmetric with the target branch,
        instead of the reference's neighbors-among-keypoints
        (deepVCP.py:54-56) that feed the Siamese DFE structurally
        incomparable inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from deepvcp.config import DeepVCPConfig
from deepvcp.models.layers import (
    CPG,
    FeatEmbedding,
    FeatureExtraction,
    WeightingLayer,
)
from deepvcp.models.nn import Module
from deepvcp.ops import (
    apply_rigid,
    farthest_point_sample,
    group_neighbors,
    index_points,
    knn,
    voxelize,
)
from deepvcp.ops.knn import approx_knn

_EPS = 1e-8


@dataclasses.dataclass(eq=False)
class DeepVCP(Module):
    """End-to-end virtual-corresponding-point prediction.

    __call__(src_pts, tgt_pts, R_init, t_init) ->
        (src_keypts [B,K,3], tgt_vcp [B,K,3], aux dict)

    src_pts/tgt_pts: [B, N, 3] or [B, N, 6] (xyz + normals), channels last.
    R_init: [B, 3, 3], t_init: [B, 3] warm-start pose (the training driver
    passes the ground-truth rotation, ref train.py:104-105).
    """

    cfg: DeepVCPConfig
    axis_name: Optional[str] = None
    # Optional ("data", "point") jax.sharding.Mesh: when set (and the
    # point axis has > 1 devices that divide N and K*C), the candidate
    # KNN — the one stage whose [chunk, N] distance tiles and [N, 3+F]
    # gather sources would otherwise be materialized per device under
    # plain GSPMD point sharding — runs as the ppermute ring
    # (ops/distributed.ring_knn): each device only ever holds a
    # [M/P, N/P] tile and one target-shard block, and the shard
    # exchange is a ppermute ring. Exact KNN. Shapes that don't divide
    # the point axis (e.g. the B=1 init call) fall back to the
    # single-device engines below.
    knn_mesh: Optional[object] = None

    def _use_ring(self, n_ref: int, n_query: int, k: int) -> bool:
        """Static (trace-time) gate for the ring candidate KNN: a point
        mesh axis with > 1 devices that divides both clouds' shapes."""
        if self.knn_mesh is None:
            return False
        from deepvcp.parallel.mesh import POINT_AXIS

        shape = dict(self.knn_mesh.shape)
        p = shape.get(POINT_AXIS, 1)
        return (
            p > 1
            and n_ref % p == 0
            and n_query % p == 0
            and k <= n_ref // p
        )

    def forward(
        self,
        src_pts: jax.Array,
        tgt_pts: jax.Array,
        R_init: jax.Array,
        t_init: jax.Array,
        train: bool = False,
    ) -> Tuple[jax.Array, jax.Array, Dict[str, jax.Array]]:
        cfg = self.cfg.resolve()
        dtype = jnp.dtype(cfg.compute_dtype)
        B, N, _ = src_pts.shape
        K = cfg.num_keypoints
        ns = cfg.num_neighbors
        C = cfg.num_candidates

        src_xyz = src_pts[..., :3]
        tgt_xyz = tgt_pts[..., :3]
        src_nrm = src_pts[..., 3:6] if cfg.use_normal else None
        tgt_nrm = tgt_pts[..., 3:6] if cfg.use_normal else None

        fe = FeatureExtraction(cfg, axis_name=self.axis_name, dtype=dtype, name="fe")
        wl = WeightingLayer(cfg.wl_mlp, dtype=dtype, name="wl")
        dfe = FeatEmbedding(
            cfg.dfe_mlp, activation=cfg.dfe_activation, dtype=dtype, name="dfe"
        )
        cpg = CPG(
            cfg.cpg_channels, grid_size=cfg.grid_size, dtype=dtype, name="cpg"
        )

        # --- source branch -------------------------------------------------
        src_feat = fe(src_xyz, src_nrm, train)            # [B,N,F]
        saliency = wl(src_feat)                            # [B,N]
        if cfg.keypoint_selection == "salient_fps":
            # spread-enforcing selection: FPS over the top-(mult*K)
            # saliency pool. On density-gradient clouds plain top-K
            # clusters in the dense core and the pose solve loses its
            # lever arm (see config.keypoint_selection).
            P = min(cfg.keypoint_pool_mult * K, src_xyz.shape[1])
            pool_sal, pool_idx = jax.lax.top_k(saliency, P)   # [B,P]
            pool_xyz = index_points(src_xyz, pool_idx)        # [B,P,3]
            sel = farthest_point_sample(pool_xyz, K)          # [B,K]
            kp_idx = jnp.take_along_axis(pool_idx, sel, axis=1)
            kp_saliency = jnp.take_along_axis(pool_sal, sel, axis=1)
        else:  # "topk": reference parity (weighting_layer.py:31-33)
            kp_saliency, kp_idx = jax.lax.top_k(saliency, K)  # [B,K]
        kp_xyz = index_points(src_xyz, kp_idx)             # [B,K,3]
        kp_feat = index_points(src_feat, kp_idx)           # [B,K,F]

        if cfg.dfe_src_neighbors == "cloud":
            # D13 fix: source descriptors from the keypoint's ns-NN in the
            # FULL source cloud — the same construction the target branch
            # applies to each candidate, so the Siamese DFE compares
            # like-for-like neighborhoods. K*ns queries are tiny (one
            # [K, N] distance tile); zero-hit masking is unnecessary (a
            # k-NN query always returns k real points).
            if cfg.use_approx_knn:
                _, nb_idx = approx_knn(
                    src_xyz, kp_xyz, ns,
                    select_dtype=cfg.knn_select_dtype_effective,
                )
            else:
                _, nb_idx = knn(src_xyz, kp_xyz, ns)
            snb = index_points(
                jnp.concatenate([src_xyz, src_feat], axis=-1), nb_idx
            )                                              # [B,K,ns,3+F]
            local_xyz = snb[..., :3] - kp_xyz[:, :, None, :]
            nb_feat = snb[..., 3:]
        else:
            # reference parity: group keypoints among themselves
            # (ref deepVCP.py:54-56)
            _, local_xyz, nb_idx, nb_count = group_neighbors(
                cfg.group_radius, ns, kp_xyz, kp_xyz, features=None,
                return_count=True,
            )                                              # [B,K,ns,3], [B,K,ns]
            # zero-hit mask: self-inclusion makes count >= 1 here, but the
            # gathered features must never ride an unmasked clamped index
            # (review finding — masking is free, the garbage is not)
            nb_feat = jnp.where(
                (nb_count > 0)[..., None, None],
                index_points(kp_feat, nb_idx), 0.0,
            )                                              # [B,K,ns,F] (D8)

        # distance-normalized feature weighting + local coords
        # (ref get_cat_feat_src.py:35-53)
        d_src = jnp.linalg.norm(local_xyz, axis=-1)        # [B,K,ns]
        w_src = d_src / (jnp.sum(d_src, axis=-1, keepdims=True) + _EPS)
        src_cat = jnp.concatenate(
            [local_xyz, nb_feat * w_src[..., None]], axis=-1
        )                                                  # [B,K,ns,3+F]

        # --- target branch -------------------------------------------------
        tgt_feat = fe(tgt_xyz, tgt_nrm, train)             # shared weights

        # warm-start transform + voxel candidate grid (D3: t applied)
        kp_warm = apply_rigid(kp_xyz, R_init, t_init)
        candidates = voxelize(
            kp_warm, cfg.search_radius, cfg.voxel_len,
            centered=cfg.centered_grid,
        )
        cand_flat = candidates.reshape(B, K * C, 3)

        # candidate KNN grouping against the target cloud — the reference's
        # knn_cuda call site (get_cat_feat_tgt.py:44-52): [chunk, N]
        # distance tiles and a k-smallest selection (ops/knn.py). "dense"
        # keeps the exact-KNN oracle semantics.
        if self._use_ring(N, K * C, ns):
            from deepvcp.ops.distributed import ring_knn
            from deepvcp.parallel.mesh import DATA_AXIS

            mesh = self.knn_mesh
            batch_axis = (
                DATA_AXIS
                if (DATA_AXIS in mesh.shape and mesh.shape[DATA_AXIS] > 1
                    and B % mesh.shape[DATA_AXIS] == 0)
                else None
            )
            _, tnb_idx = ring_knn(
                mesh, tgt_xyz, cand_flat, ns, batch_axis=batch_axis
            )
        elif cfg.use_two_level_tgt_knn:
            # two-level grouping (ops/two_level.py): per-keypoint top-T
            # table -> candidate k-NN in keypoint-LOCAL coordinates
            # (bf16-safe at any absolute scale) -> row gather from the
            # table. Replaces the [K*C, N] selection tile + 442k-row gather
            # below with a [K, N] tile + K*T rows.
            from deepvcp.ops.two_level import two_level_rows

            tnb = two_level_rows(
                tgt_xyz,
                jnp.concatenate([tgt_xyz, tgt_feat], axis=-1),
                kp_warm, candidates, ns,
                table_size=cfg.tgt_knn_table,
                select_dtype=cfg.knn_select_dtype,
                center_select_dtype=cfg.knn_select_dtype_effective,
            ).reshape(B, K * C, ns, -1)
            tnb_idx = None
        elif cfg.use_approx_knn:
            # reduced-precision selection is gated on cloud scale (see
            # config.knn_select_f32_extent; review finding on bf16
            # cancellation at KITTI-scale coordinates)
            sel = cfg.knn_select_dtype_effective
            _, tnb_idx = approx_knn(
                tgt_xyz, cand_flat, ns, chunk=cfg.knn_query_chunk,
                select_dtype=sel,
            )
        else:
            _, tnb_idx = knn(tgt_xyz, cand_flat, ns, chunk=cfg.query_chunk)
        # one fused [B, N, 3+F] gather instead of separate xyz/feature
        # gathers (one row per neighbour, not two)
        if tnb_idx is not None:
            tnb = index_points(
                jnp.concatenate([tgt_xyz, tgt_feat], axis=-1), tnb_idx
            )                                              # [B,KC,ns,3+F]
        tnb_xyz, tnb_feat = tnb[..., :3], tnb[..., 3:]
        local_t = tnb_xyz - cand_flat[:, :, None, :]
        if cfg.derotate_tgt_neighborhoods:
            # D14 fix: canonicalize target neighborhoods into the source
            # frame via the warm-start rotation (row-vector form of
            # R_init^T @ v); distances are unchanged, so the weighting
            # below is identical either way.
            local_t = jnp.einsum("bqnj,bji->bqni", local_t, R_init)
        # recompute distances from the gathered coordinates: identical
        # values, and the gradient path through the distance weights stays
        # a plain norm instead of routing through approx_min_k
        nb_dist = jnp.linalg.norm(local_t, axis=-1)        # [B,KC,ns]
        w_tgt = nb_dist / (jnp.sum(nb_dist, axis=-1, keepdims=True) + _EPS)
        tgt_cat = jnp.concatenate(
            [local_t, tnb_feat * w_tgt[..., None]], axis=-1
        ).reshape(B, K, C, ns, -1)

        # --- embedding + correspondence ------------------------------------
        src_desc = dfe(src_cat)                            # [B,K,F]
        tgt_desc = dfe(tgt_cat)                            # [B,K,C,F]
        vcp, cand_weights = cpg(src_desc, tgt_desc, candidates)

        aux = {
            "saliency": saliency,
            "keypoint_idx": kp_idx,
            "keypoint_saliency": kp_saliency,
            "candidate_weights": cand_weights,
            "src_descriptors": src_desc,
        }
        return kp_xyz, vcp, aux


def create_deepvcp(cfg: DeepVCPConfig, axis_name: Optional[str] = None) -> DeepVCP:
    return DeepVCP(cfg=cfg, axis_name=axis_name)
