"""Neural modules (L2 replacement; SURVEY.md §2.2-§2.9).

Modules of the functional layer in models/nn.py, all natively batched
(the reference's B=1 lock-in, defect D1, does not exist here). Choices:

- the per-group "1x1 conv" MLP is a Dense stack (same math as the
  reference's Conv2d-with-kernel-1 stacks, pointnet2_utils.py:196-198), so
  it runs as plain matmuls;
- the first SA-layer projection is algebraically split into
  `project-then-gather`: the feature half of Dense(concat(xyz, feat[idx]))
  is computed once per point on [N, D] and then gathered, instead of
  being recomputed for each of the nsample copies of the point — a ~10x
  FLOP reduction on the wide stages with zero numerics change;
- BatchNorm supports an `axis_name` for exact cross-device statistics under
  data parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from deepvcp.config import DeepVCPConfig, SALayerConfig
from deepvcp.ops import (
    farthest_point_sample,
    group_neighbors,
    index_points,
)
from deepvcp.models.fused_sa import BandedSetAbstraction
from deepvcp.models.nn import (
    BatchNorm,
    Conv,
    Dense,
    Module,
    relu,
    softplus,
)
from deepvcp.ops.neighbors import (
    SortedCloud,
    sort_cloud,
    window_for,
    windowed_ball_query,
)

Dtype = Any


@dataclasses.dataclass(eq=False)
class SetAbstraction(Module):
    """PointNet++ set-abstraction stage (ref pointnet2_utils.py:161-202).

    sample (FPS, skipped when npoint == N where it is just a permutation,
    deep_feat_extraction.py:10-14) -> ball-query group -> shared MLP ->
    max-pool over the neighbor axis.
    """

    layer: SALayerConfig
    use_batchnorm: bool = True
    query_chunk: Optional[int] = None
    axis_name: Optional[str] = None
    dtype: Dtype = jnp.float32
    window: Optional[int] = None  # windowed neighbor search when set

    def forward(
        self,
        xyz: jax.Array,
        features: Optional[jax.Array],
        train: bool = False,
        sorted_cloud: Optional[SortedCloud] = None,
    ) -> Tuple[jax.Array, jax.Array]:
        """xyz [B, N, 3], features [B, N, D] or None ->
        (new_xyz [B, S, 3], new_features [B, S, mlp[-1]]).

        With `sorted_cloud` + `window` set (and npoint == N), neighbor
        search uses the sort-free windowed engine; xyz/features must then be
        in sorted order and outputs stay in sorted order."""
        cfg = self.layer
        N = xyz.shape[1]
        use_window = (
            sorted_cloud is not None
            and self.window is not None
            and cfg.npoint == N
        )
        if cfg.npoint == N:
            new_xyz = xyz
        else:
            fps_idx = farthest_point_sample(xyz, cfg.npoint)
            new_xyz = index_points(xyz, fps_idx)

        c0 = cfg.mlp[0]
        # First projection, split: Dense(concat(local_xyz, feat[idx])) ==
        # local_xyz @ Wx + (feat @ Wf)[idx] + b.
        xyz_proj = Dense(c0, dtype=self.dtype, name="proj_xyz")
        if use_window:
            idx, count = windowed_ball_query(
                sorted_cloud, new_xyz, cfg.radius, cfg.nsample, self.window,
                return_count=True,
            )
            local_xyz = index_points(xyz, idx) - new_xyz[..., :, None, :]
        else:
            _, local_xyz, idx, count = group_neighbors(
                cfg.radius, cfg.nsample, xyz, new_xyz, features=None,
                chunk=self.query_chunk, return_count=True,
            )
        h = xyz_proj(local_xyz.astype(self.dtype))  # [B,S,ns,c0]
        if features is not None:
            feat_proj = Dense(
                c0, use_bias=False, dtype=self.dtype, name="proj_feat"
            )(features.astype(self.dtype))          # [B,N,c0]
            h = h + index_points(feat_proj, idx)
        # Zero-hit queries (possible when a windowed slab overflows the
        # static window on density-gradient clouds, or for foreign query
        # points) gathered garbage — zero their rows BEFORE the MLP+pool so
        # no far point's geometry pollutes the pooled feature (review
        # finding; the reference crashes here, pointnet2_utils.py:100-106).
        h = jnp.where((count > 0)[..., None, None], h, 0.0)

        def norm_act(x, i):
            if self.use_batchnorm:
                x = BatchNorm(
                    use_running_average=not train,
                    axis_name=self.axis_name,
                    dtype=self.dtype,
                    name=f"bn{i}",
                )(x)
            return relu(x)

        h = norm_act(h, 0)
        for i, c in enumerate(cfg.mlp[1:], start=1):
            h = Dense(c, dtype=self.dtype, name=f"dense{i}")(h)
            h = norm_act(h, i)

        # max over the neighbor axis (ref pointnet2_utils.py:200)
        return new_xyz, jnp.max(h, axis=2)


@dataclasses.dataclass(eq=False)
class FeatureExtraction(Module):
    """FE stack: chained SA layers + final projection to feat_dim.

    Fixes reference defects D2 (deep_feat_extraction.py:26-28 feeds raw
    normals into every stage; we chain each stage's output features) and D4
    (the declared 64->32 projection at deep_feat_extraction.py:15 is never
    applied; we apply it).
    """

    cfg: DeepVCPConfig
    axis_name: Optional[str] = None
    dtype: Dtype = jnp.float32

    def forward(
        self,
        xyz: jax.Array,
        normals: Optional[jax.Array],
        train: bool = False,
    ) -> jax.Array:
        """xyz [B, N, 3], normals [B, N, 3] or None -> features [B, N, feat_dim].

        With cfg.neighbor_method == "windowed", the cloud is sorted along one
        spatial axis once, all SA stages run in sorted order with windowed
        neighbor search, and the final features are unpermuted back to the
        caller's point order."""
        cfg = self.cfg.resolve()
        windowed = cfg.neighbor_method in ("windowed", "banded")
        banded = cfg.neighbor_method == "banded"
        cloud = None
        inv_perm = None
        if windowed:
            cloud = sort_cloud(xyz)
            if normals is not None:
                normals = index_points(normals, cloud.perm)
            xyz = cloud.xyz
            N = xyz.shape[1]
            inv_perm = (
                jnp.zeros((xyz.shape[0], N), jnp.int32)
                .at[
                    jnp.arange(xyz.shape[0], dtype=jnp.int32)[:, None],
                    cloud.perm,
                ]
                .set(jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32), cloud.perm.shape))
            )
        feats = normals
        for i, layer in enumerate(cfg.sa_layers):
            window = (
                window_for(
                    xyz.shape[1],
                    layer.radius,
                    cfg.spatial_extent,
                    cfg.window_safety,
                )
                if windowed
                else None
            )
            if banded:
                feats = BandedSetAbstraction(
                    layer,
                    window=window,
                    tile=cfg.band_tile,
                    use_batchnorm=cfg.use_batchnorm,
                    axis_name=self.axis_name,
                    dtype=self.dtype,
                    name=f"sa{i + 1}",
                )(xyz, feats, train)
            else:
                xyz, feats = SetAbstraction(
                    layer,
                    use_batchnorm=cfg.use_batchnorm,
                    query_chunk=cfg.query_chunk,
                    axis_name=self.axis_name,
                    dtype=self.dtype,
                    window=window,
                    name=f"sa{i + 1}",
                )(xyz, feats, train, sorted_cloud=cloud)
        feats = Dense(cfg.feat_dim, dtype=self.dtype, name="proj")(feats)
        if windowed:
            feats = index_points(feats, inv_perm)
        return feats


@dataclasses.dataclass(eq=False)
class WeightingLayer(Module):
    """Per-point saliency MLP 32->16->8->1, ReLU/ReLU/Softplus
    (ref weighting_layer.py:8-24). Returns the saliency scores; top-k
    selection is the caller's job (keeps this module shape-polymorphic)."""

    mlp: Tuple[int, ...] = (16, 8, 1)
    dtype: Dtype = jnp.float32

    def forward(self, features: jax.Array) -> jax.Array:
        """features [B, N, D] -> saliency [B, N] (non-negative)."""
        x = features.astype(self.dtype)
        for f in self.mlp[:-1]:
            x = relu(Dense(f, dtype=self.dtype)(x))
        x = softplus(Dense(self.mlp[-1], dtype=self.dtype)(x))
        return x[..., 0]


@dataclasses.dataclass(eq=False)
class FeatEmbedding(Module):
    """Shared (Siamese) DFE MLP 35->32->32->32 + max-pool over the neighbor
    axis (ref deep_feat_embedding.py:13-61). One module handles both the
    source [B,K,ns,35] and target [B,K,C,ns,35] layouts: the pool is always
    over axis -2.

    `activation=True` inserts ReLU between hidden layers (the reference
    stacks bare Linear layers, which collapse to one affine map —
    deep_feat_embedding.py:32-34; set False for strict parity)."""

    mlp: Tuple[int, ...] = (32, 32, 32)
    activation: bool = True
    dtype: Dtype = jnp.float32

    def forward(self, x: jax.Array) -> jax.Array:
        x = x.astype(self.dtype)
        for i, f in enumerate(self.mlp):
            x = Dense(f, dtype=self.dtype)(x)
            if self.activation and i + 1 < len(self.mlp):
                x = relu(x)
        return jnp.max(x, axis=-2)


@dataclasses.dataclass(eq=False)
class CPG(Module):
    """Corresponding-point generation (ref cpg.py:18-60): squared-difference
    cost volume on the voxel grid -> 3 x Conv3D (no nonlinearity, matching
    cpg.py:45-47) -> softmax over candidates -> weighted-centroid VCP.

    Fixes reference defect D11: cpg.py:34 reshapes its [B,N,32,C] input
    straight to the (gs,gs,gs,32) grid without permuting, scrambling the
    feature and candidate axes; here the volume is laid out candidate-major
    as intended (parity against the reference's conv machinery is in
    tests/test_reference_parity.py::TestCPG)."""

    channels: Tuple[int, ...] = (16, 4, 1)
    grid_size: int = 6
    dtype: Dtype = jnp.float32

    def forward(
        self,
        src_desc: jax.Array,
        tgt_desc: jax.Array,
        candidates: jax.Array,
    ) -> Tuple[jax.Array, jax.Array]:
        """src_desc [B,K,F], tgt_desc [B,K,C,F], candidates [B,K,C,3] ->
        (vcp [B,K,3], weights [B,K,C])."""
        B, K, C, F = tgt_desc.shape
        gs = self.grid_size
        assert C == gs**3, f"candidates {C} != grid {gs}^3"
        cost = jnp.square(src_desc[:, :, None, :] - tgt_desc)
        x = cost.reshape(B * K, gs, gs, gs, F).astype(self.dtype)
        for ch in self.channels:
            x = Conv(ch, kernel_size=(3, 3, 3), dtype=self.dtype)(x)
        logits = x.reshape(B, K, C)
        weights = jax.nn.softmax(logits, axis=-1)
        # The reference re-divides by sum(weights)==1 (cpg.py:58); softmax
        # already normalizes.
        vcp = jnp.einsum("bkc,bkcd->bkd", weights, candidates)
        return vcp, weights
