"""Multi-scale grouping and feature-propagation stages.

The reference ships (but never wires up) `PointNetSetAbstractionMsg` and
`PointNetFeaturePropagation` (pointnet2_utils.py:205-315, SURVEY.md §2.2
"unused"). They are part of the PointNet++ capability surface — MSG for
multi-radius local features, FP for decoder-style upsampling — so the
framework provides them as first-class modules, batched and jittable.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from deepvcp.models.nn import BatchNorm, Dense, Module, relu

from deepvcp.ops import (
    farthest_point_sample,
    group_neighbors,
    index_points,
    square_distance,
)


@dataclasses.dataclass(eq=False)
class SetAbstractionMSG(Module):
    """Multi-scale grouping SA (ref pointnet2_utils.py:205-262): one FPS
    sampling, several (radius, nsample, mlp) branches, concatenated."""

    npoint: int
    radius_list: Sequence[float]
    nsample_list: Sequence[int]
    mlp_list: Sequence[Sequence[int]]
    use_batchnorm: bool = True
    dtype: Any = jnp.float32

    def forward(
        self,
        xyz: jax.Array,
        features: Optional[jax.Array],
        train: bool = False,
    ) -> Tuple[jax.Array, jax.Array]:
        """xyz [B, N, 3], features [B, N, D] ->
        (new_xyz [B, npoint, 3], feats [B, npoint, sum(mlp[-1])])."""
        N = xyz.shape[1]
        if self.npoint == N:
            new_xyz = xyz
        else:
            idx = farthest_point_sample(xyz, self.npoint)
            new_xyz = index_points(xyz, idx)

        outs = []
        for i, (radius, nsample, mlp) in enumerate(
            zip(self.radius_list, self.nsample_list, self.mlp_list)
        ):
            grouped, _, _ = group_neighbors(
                radius, nsample, xyz, new_xyz, features
            )
            h = grouped.astype(self.dtype)
            for j, c in enumerate(mlp):
                h = Dense(c, dtype=self.dtype, name=f"b{i}_dense{j}")(h)
                if self.use_batchnorm:
                    h = BatchNorm(
                        use_running_average=not train,
                        dtype=self.dtype,
                        name=f"b{i}_bn{j}",
                    )(h)
                h = relu(h)
            outs.append(jnp.max(h, axis=2))
        return new_xyz, jnp.concatenate(outs, axis=-1)


@dataclasses.dataclass(eq=False)
class FeaturePropagation(Module):
    """Inverse-distance-weighted 3-NN feature interpolation + unit MLP
    (ref pointnet2_utils.py:265-315): propagates coarse features back to a
    dense point set (decoder stage)."""

    mlp: Sequence[int]
    use_batchnorm: bool = True
    dtype: Any = jnp.float32

    def forward(
        self,
        xyz_dense: jax.Array,
        xyz_sparse: jax.Array,
        feat_dense: Optional[jax.Array],
        feat_sparse: jax.Array,
        train: bool = False,
    ) -> jax.Array:
        """xyz_dense [B, N, 3], xyz_sparse [B, S, 3],
        feat_dense [B, N, D1] or None, feat_sparse [B, S, D2] ->
        [B, N, mlp[-1]]."""
        S = xyz_sparse.shape[1]
        if S == 1:
            interpolated = jnp.repeat(feat_sparse, xyz_dense.shape[1], axis=1)
        else:
            d = square_distance(xyz_dense, xyz_sparse)       # [B, N, S]
            neg, idx = jax.lax.top_k(-d, 3)
            w = 1.0 / (jnp.maximum(-neg, 0.0) + 1e-8)        # [B, N, 3]
            w = w / jnp.sum(w, axis=-1, keepdims=True)
            gathered = index_points(feat_sparse, idx)        # [B, N, 3, D2]
            interpolated = jnp.einsum("bnk,bnkd->bnd", w, gathered)

        h = interpolated
        if feat_dense is not None:
            h = jnp.concatenate([feat_dense, interpolated], axis=-1)
        h = h.astype(self.dtype)
        for j, c in enumerate(self.mlp):
            h = Dense(c, dtype=self.dtype, name=f"dense{j}")(h)
            if self.use_batchnorm:
                h = BatchNorm(
                    use_running_average=not train,
                    dtype=self.dtype,
                    name=f"bn{j}",
                )(h)
            h = relu(h)
        return h
