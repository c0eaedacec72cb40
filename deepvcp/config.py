"""Model / training configuration.

Every constant that the reference hard-codes across its files is lifted
into one frozen dataclass so a config fully specifies the model
(reference: deepVCP.py:33,54,61,76-77; deep_feat_extraction.py:10-15;
deep_feat_embedding.py:14-21; weighting_layer.py:11-24; train.py:38-42).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SALayerConfig:
    """One PointNet++ set-abstraction stage (ref pointnet2_utils.py:161-202)."""

    npoint: int          # number of sampled centroids (== N means "keep all")
    radius: float        # ball-query radius
    nsample: int         # neighbors per centroid
    mlp: Tuple[int, ...] # per-group 1x1-conv channel widths


@dataclasses.dataclass(frozen=True)
class DeepVCPConfig:
    """Full model spec.

    Defaults reproduce the reference's constants for 10k-point clouds.
    The corrected feature chaining (SURVEY.md defect D2) means SA input
    channels are (3 local xyz + previous features); `feat_dim` is the final
    per-point descriptor width after the 64->32 projection (defect D4 fixed:
    the projection is actually applied).
    """

    num_points: int = 10000          # N, points per cloud (ref train.py:58)
    use_normal: bool = True          # ModelNet has normals, KITTI does not
    num_keypoints: int = 64          # K_topk (ref deepVCP.py:33)
    num_neighbors: int = 32          # nsample for keypoint grouping & tgt KNN
    group_radius: float = 1.0        # keypoint ball-query radius (ref deepVCP.py:54)
    search_radius: float = 1.0       # r: candidate search radius (ref deepVCP.py:76)
    voxel_len: float = 0.4           # s: candidate voxel edge (ref deepVCP.py:77)
    feat_dim: int = 32               # per-point descriptor width
    # FE stack (ref deep_feat_extraction.py:10-15), with corrected chaining:
    sa_layers: Tuple[SALayerConfig, ...] = (
        SALayerConfig(npoint=-1, radius=0.1, nsample=256, mlp=(16, 16, 32)),
        SALayerConfig(npoint=-1, radius=0.2, nsample=128, mlp=(32, 64)),
        SALayerConfig(npoint=-1, radius=0.4, nsample=64, mlp=(64, 64)),
    )
    # Weighting layer MLP widths (ref weighting_layer.py:11-24)
    wl_mlp: Tuple[int, ...] = (16, 8, 1)
    # DFE MLP widths (ref deep_feat_embedding.py:18-20)
    dfe_mlp: Tuple[int, ...] = (32, 32, 32)
    # CPG 3D-conv channel widths (ref cpg.py:21-23)
    cpg_channels: Tuple[int, ...] = (16, 4, 1)
    # The reference stacks Linear layers with no nonlinearity in the DFE
    # (deep_feat_embedding.py:32-34); the paper intends an MLP, so we put
    # ReLU between hidden layers by default. Set False for strict parity.
    dfe_activation: bool = True
    # BatchNorm in SA conv stacks (ref pointnet2_utils.py:196-198).
    use_batchnorm: bool = True
    # Chunk size for memory-tiled pairwise-distance ops (queries per block).
    query_chunk: int = 2048
    # Compute dtype for the network MLPs ("float32" or "bfloat16").
    compute_dtype: str = "float32"
    # Neighbor search strategy for the FE stack:
    #   "banded"   gather-free banded SA (models/fused_sa.py) — the default
    #              path; pooled-then-pointwise MLP, cap-free neighborhoods;
    #   "windowed" spatially-sorted window engine with explicit neighbor
    #              gathers (ops/neighbors.py) — reference MLP-then-pool
    #              architecture, sort-free selection;
    #   "dense"    exact reference-semantics [S, N] path (ops/grouping.py).
    # "banded"/"windowed" also switch the candidate KNN to the approx_min_k
    # engine (ops.knn.approx_knn); "dense" uses exact brute-force KNN.
    neighbor_method: str = "banded"
    # Cloud diameter hint for sizing the static candidate windows
    # (ModelNet normalized clouds ~2; KITTI scans ~80-100 m).
    spatial_extent: float = 20.0
    # Window = safety * expected slab occupancy, rounded up to a multiple
    # of 128. Sizes the static band and windows of the XLA engines (the
    # GPU's pooling kernel sweeps exact slabs); raise it for very
    # non-uniform clouds.
    window_safety: float = 4.0
    # Window width for the windowed-engine neighbor search (ops/neighbors).
    knn_window: int = 512
    # Query-block size for the candidate approx-KNN [chunk, N] distance
    # tile (4608 = 64 keypoints x 72 candidates; 3 chunks cover
    # K*C=13824).
    knn_query_chunk: int = 4608
    # Distance-tile dtype for candidate-KNN *selection* (the tile is the
    # op's HBM cost; the model recomputes neighbor distances from gathered
    # coordinates in f32). None = full f32 tile.
    knn_select_dtype: str = "bfloat16"
    # Above this spatial_extent the model ignores knn_select_dtype and
    # selects in f32: even with centered coordinates and f32 accumulation
    # (ops.knn.approx_knn), bf16 input rounding costs ~2^-9*(extent/2)^2
    # of d^2 ranking error — ~0.05 m^2 at the default extent 20, but
    # several m^2 at raw KITTI scale (~100 m).
    knn_select_f32_extent: float = 50.0
    # Tile width for the banded SA stage (band = tiles of this many sorted
    # points; larger tiles -> fewer rolls -> faster compile, slightly wider
    # bands).
    band_tile: int = 256
    # Defect D12 fix (SURVEY.md §2.12): the reference's candidate grid is
    # ASYMMETRIC — per axis `arange(c - r - s/2, c + r, s)` spans
    # [-r - s/2, r - s/2] (voxelize.py:62-71), so at the defaults
    # (r=1, s=0.4) the 216 candidates average to -0.2 per axis. The CPG's
    # softmax-centroid VCP therefore starts life biased by |(-.2,-.2,-.2)|
    # = 0.35 toward the grid's low corner — measured as an RTE floor of
    # ~0.4 in both round-3 training campaigns until the grid was centered.
    # True -> offsets (j - (gs-1)/2) * s, symmetric around the warm-started
    # keypoint (uniform softmax = zero bias). False -> reference parity.
    centered_grid: bool = True
    # Defect D13 fix (SURVEY.md §2.12): the reference builds the SOURCE
    # DFE descriptor from neighbors among the 64 KEYPOINTS (deepVCP.py:54-56
    # groups src_keypts against src_keypts: inter-keypoint spacings, ~cloud
    # scale) but the TARGET descriptor from each candidate's 32-NN in the
    # full 10k cloud (get_cat_feat_tgt.py:44-52: local-surface scale). The
    # Siamese DFE then compares descriptors of structurally different
    # neighborhoods, so the CPG cost volume never sharpens.
    #   "cloud"     source neighbors = keypoint's num_neighbors-NN in the
    #               full source cloud — symmetric with the target branch
    #               (the paper's construction);
    #   "keypoints" reference parity.
    dfe_src_neighbors: str = "cloud"
    # Defect D14 fix (SURVEY.md §2.12): the Siamese DFE comparison is
    # rotation-VARIANT — the target candidate's local neighborhood differs
    # from the source keypoint's by exactly the relative rotation, so with
    # the reference's full-SO(3) training pairs (ModelNet40Dataset.py:60-75)
    # the cost volume must match descriptors across arbitrary rotations and
    # never sharpens. The warm-start rotation already estimates that
    # rotation (it IS ground truth during training, train.py:104-105), so
    # rotating the target local coordinates by R_init^T canonicalizes both
    # branches into the source frame: under GT-init training the true
    # candidate's derotated neighborhood matches the keypoint's exactly.
    # Identity-init inference is unaffected (derotation by I); iterative
    # refinement (Registrar refine_iters) supplies the estimate there.
    derotate_tgt_neighborhoods: bool = True
    # Keypoint selection policy. The reference takes the top-K points by
    # saliency (weighting_layer.py:31-33).
    #   "topk"        reference parity — AND the measured winner;
    #   "salient_fps" farthest-point sampling over the top
    #                 (keypoint_pool_mult*K) saliency pool — keeps only
    #                 salient points but enforces spatial spread (the FPS
    #                 loop is ops/sampling.py).
    # HISTORY: round 3 measured top-K clustering in the dense core of
    # density-gradient clouds (keypoint RMS lever 0.25 vs cloud 0.40)
    # and predicted salient_fps would fix the lidar accuracy gap. The
    # round-4 R1S ablation REFUTED that prediction under training:
    # salient_fps trained strictly worse on every held set (lidar
    # GT-free 22.6 vs 17.0 deg; uniform 13.0 vs 3.4 —
    # artifacts/campaign_r4/summary.json DECISION). The lidar gap was
    # train-mix distribution instead (campaign_r4c: lidar-heavy
    # fine-tune 2.1 deg with topk). Default stays "topk".
    keypoint_selection: str = "topk"
    keypoint_pool_mult: int = 4
    # Candidate/source k-NN selection engine, decoupled from the SA
    # neighbor engine so the approx-selection accuracy tax can be
    # measured on banded-arch checkpoints (whose SA params don't
    # transfer to neighbor_method="dense" — CLAUDE.md):
    #   "auto"   follow neighbor_method — lax.approx_min_k for
    #            banded/windowed, exact brute-force for dense;
    #   "exact"  exact chunked top_k regardless of engine;
    #   "approx" approx_min_k regardless of engine.
    # On the GPU, approx_min_k lowers to an exact top-k, so the modes
    # select the same neighbours there; they differ in the backend's
    # reduction only.
    # Inference-only fidelity knob: selection is not learned, so any
    # checkpoint evaluates under any setting.
    candidate_knn: str = "auto"
    # Target-branch candidate grouping structure (ops/two_level.py):
    #   "flat"      the flat [K*C, N] path (the reference's shape,
    #               get_cat_feat_tgt.py:44-52) — THE MEASURED DEFAULT;
    #   "two_level" per-keypoint top-T table, keypoint-local selection
    #               (bf16-safe at any absolute scale), rows gathered
    #               from the table;
    #   "auto"      two-level when the candidate cube is small relative
    #               to the cloud (extent >= 8x grid reach) AND approx
    #               selection is in play (the coverage regime).
    # Two-level costs +0.33 deg GT-free RRE at KITTI scale (the models
    # are trained with flat selection; campaign_r5b W5), so the default
    # is "flat"; "two_level" remains for memory-bound cases (it never
    # materializes the [K*C, N] tile). Its speed on the GPU is not
    # measured.
    tgt_knn: str = "flat"
    # T: table rows per keypoint for the two-level path.
    tgt_knn_table: int = 512

    @property
    def in_channels(self) -> int:
        return 6 if self.use_normal else 3

    @property
    def knn_select_dtype_effective(self):
        """The selection dtype the model ACTUALLY uses: knn_select_dtype
        gated on the declared cloud scale (see knn_select_f32_extent).
        Every consumer (model forward, profiler) must read this property so
        a profiled stage can never run in a precision mode the model
        doesn't (round-2 advisor finding)."""
        if self.spatial_extent <= self.knn_select_f32_extent:
            return self.knn_select_dtype
        return None

    @property
    def use_approx_knn(self) -> bool:
        """Whether candidate/source k-NN selection runs on the
        approx_min_k engine (see candidate_knn)."""
        if self.candidate_knn == "auto":
            return self.neighbor_method in ("windowed", "banded")
        return self.candidate_knn == "approx"

    @property
    def grid_reach(self) -> float:
        """Half-extent of the candidate cube around a warm keypoint
        (centered grid: search_radius; the reference's asymmetric grid
        adds voxel_len/2 on the negative side — use the larger)."""
        return self.search_radius + (
            0.0 if self.centered_grid else self.voxel_len / 2.0)

    @property
    def use_two_level_tgt_knn(self) -> bool:
        """Whether the target branch groups candidates via the
        two-level per-keypoint-table path (see tgt_knn)."""
        if self.tgt_knn == "flat":
            return False
        if self.tgt_knn == "two_level":
            return True
        return (
            self.use_approx_knn
            and self.spatial_extent >= 8.0 * max(self.grid_reach, 1e-6)
        )

    @property
    def grid_size(self) -> int:
        return int(round(2.0 * self.search_radius / self.voxel_len)) + 1

    @property
    def num_candidates(self) -> int:
        return self.grid_size ** 3

    def resolve(self) -> "DeepVCPConfig":
        """Replace npoint=-1 sentinels with num_points; validate enum-like
        string fields and the banded engine's geometry assumption."""
        # Enum-string validation (review finding): every consumer of these
        # fields branches with `== "..."` / `in (...)`, so a typo'd value
        # ("Cloud", "window") would silently select the fallback branch —
        # for dfe_src_neighbors that fallback is the DEFECTIVE
        # reference-parity path the "cloud" mode exists to fix.
        if self.neighbor_method not in ("banded", "windowed", "dense"):
            raise ValueError(
                f"neighbor_method must be one of 'banded'/'windowed'/'dense'"
                f", got {self.neighbor_method!r}"
            )
        if self.keypoint_selection not in ("topk", "salient_fps"):
            raise ValueError(
                f"keypoint_selection must be 'topk' (reference parity) or "
                f"'salient_fps', got {self.keypoint_selection!r}"
            )
        if self.keypoint_pool_mult < 1:
            # pool_mult=0 would make the salient_fps branch call
            # top_k(k=0) and FPS over an empty pool with a confusing
            # downstream error (round-3 advisor finding)
            raise ValueError(
                f"keypoint_pool_mult must be >= 1, got "
                f"{self.keypoint_pool_mult}"
            )
        if self.candidate_knn not in ("auto", "exact", "approx"):
            raise ValueError(
                f"candidate_knn must be 'auto'/'exact'/'approx', got "
                f"{self.candidate_knn!r}"
            )
        if self.tgt_knn not in ("auto", "two_level", "flat"):
            raise ValueError(
                f"tgt_knn must be 'auto'/'two_level'/'flat', got "
                f"{self.tgt_knn!r}"
            )
        if self.tgt_knn_table < 1:
            raise ValueError(
                f"tgt_knn_table must be >= 1, got {self.tgt_knn_table}"
            )
        if self.dfe_src_neighbors not in ("cloud", "keypoints"):
            raise ValueError(
                f"dfe_src_neighbors must be 'cloud' (D13 fix) or "
                f"'keypoints' (reference parity), got "
                f"{self.dfe_src_neighbors!r}"
            )
        if self.neighbor_method == "banded":
            rmax = max(l.radius for l in self.sa_layers)
            if 2.0 * rmax >= self.spatial_extent:
                # The XLA static-band path builds its band with a torus
                # roll (models/fused_sa.py band_of); wrap-around pairs are
                # killed by the 3-D distance mask ONLY when the cloud
                # extent exceeds 2r. Fail loudly instead of silently
                # mis-pooling / mis-crediting gradients (review finding).
                raise ValueError(
                    f"banded neighbor engine requires spatial_extent > "
                    f"2*max(SA radius) = {2.0 * rmax} (got "
                    f"{self.spatial_extent}); raise spatial_extent or use "
                    f"neighbor_method='windowed'/'dense'"
                )
        layers = tuple(
            dataclasses.replace(l, npoint=self.num_points) if l.npoint == -1 else l
            for l in self.sa_layers
        )
        return dataclasses.replace(self, sa_layers=layers)

    @staticmethod
    def kitti_scale(
        num_points: int = 10000, use_normal: bool = False
    ) -> "DeepVCPConfig":
        """The velodyne-scale operating point (ref KITTIDataset.py:31-49:
        meter-coordinate scans, ~25 m range). spatial_extent=55 sits above
        knn_select_f32_extent, so candidate-KNN selection runs in f32
        (bf16 mantissas cancel on meter-scale squared distances); the
        candidate grid keeps the reference's meter-scale reach
        (search_radius=1.0, voxel_len=0.4). Validated end-to-end by the
        round-4 K1 campaign (artifacts/campaign_r4b/summary.json): trained
        GT-free RRE 0.27 deg / RTE 0.0097 m with 2 guarded refine
        iterations on held-out 25 m lidar-like pairs."""
        return DeepVCPConfig(
            num_points=num_points,
            use_normal=use_normal,
            spatial_extent=55.0,
        )

    @staticmethod
    def tiny(num_points: int = 128, use_normal: bool = True) -> "DeepVCPConfig":
        """Small config for tests / compile checks (same topology, tiny N)."""
        return DeepVCPConfig(
            num_points=num_points,
            use_normal=use_normal,
            num_keypoints=16,
            num_neighbors=8,
            sa_layers=(
                SALayerConfig(npoint=-1, radius=0.4, nsample=16, mlp=(16, 16, 32)),
                SALayerConfig(npoint=-1, radius=0.8, nsample=16, mlp=(32, 64)),
                SALayerConfig(npoint=-1, radius=1.2, nsample=8, mlp=(64, 64)),
            ),
            query_chunk=64,
            spatial_extent=4.0,
            knn_window=min(128, num_points),
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters (ref train.py:38-42)."""

    num_epochs: int = 10
    batch_size: int = 1
    learning_rate: float = 1e-3
    alpha: float = 0.5               # loss balancing factor
    inlier_ratio: float = 0.8        # SVD outlier rejection keep-fraction
    # Weight of the paper's direct per-keypoint VCP L1 term (DeepVCP
    # Eq. 5). The reference only supervises the rigid FIT of the VCPs
    # (deepVCP_loss.py:110-119), so per-point correspondence errors that
    # cancel in the solve get no gradient; > 0 adds the direct term.
    # 0 keeps exact reference-loss semantics.
    vcp_loss_weight: float = 0.0
    # Weight of the explicit rotation term on the SOLVED pose
    # (loss/registration.py rot_weight: mean ||R2 - R_gt||_F, ~2*theta).
    # The round-5 rotation-wall fix: at KITTI scale the point-space terms
    # are translation-dominated and rotation plateaus at 0.27-0.9 deg;
    # this term re-weights the under-supervised component. 0 = off.
    rot_loss_weight: float = 0.0
    # Fine-tune mode: BatchNorm consumes the checkpoint's running
    # statistics and never updates them (see trainer loss_fn — the
    # round-5 long-continuation drift pathology). Use for continued
    # training of converged checkpoints; leave False for from-scratch.
    freeze_batch_stats: bool = False
    # "constant" (reference parity) or "cosine" (warmup_steps linear
    # warmup then cosine decay over total_steps to 1% of learning_rate).
    lr_schedule: str = "constant"
    warmup_steps: int = 100
    total_steps: int = 0             # required for lr_schedule="cosine"
    grad_clip_norm: float = 10.0     # global-norm clip; 0 disables
                                     # (untrained grads spike to ~1e4 through
                                     # the SVD backward — observed)
    # Weight the SVD solves by keypoint saliency (the paper's weighted
    # Kabsch). The reference's weighting layer receives NO gradient (its
    # output only picks top-k indices, weighting_layer.py:31-33); with this
    # on, saliency flows into the loss and the layer actually trains.
    use_saliency_weights: bool = False
    # --- warm-start distribution during training ---------------------------
    # The reference trains with R_init = R_gt, t_init = 0 (train.py:104-105),
    # so the network must span the full translation range with its candidate
    # grid AND only ever sees EXACT rotation inits — measured consequence
    # (round-3 campaign Q4): Registrar refinement DIVERGES (20->54->78 deg
    # over 3 iters) because a slightly-wrong init is out of distribution.
    # Training on a JITTERED ground-truth pose makes the network a residual
    # contraction (each pass maps an init within the jitter ball closer to
    # truth), which is what iterative refinement needs; pair it with a
    # smaller search_radius/voxel_len for a lower soft-argmax floor.
    #   init_translation: "zero" (reference parity) or "gt" (residual mode —
    #     t_init = t_gt + U[-init_trans_jitter, +init_trans_jitter]^3).
    #   init_rot_jitter_deg: R_init = dR @ R_gt, dR uniform-axis rotation
    #     with angle U[0, init_rot_jitter_deg] (0 = exact, parity).
    init_translation: str = "zero"
    init_rot_jitter_deg: float = 0.0
    init_trans_jitter: float = 0.0
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    checkpoint_every_epochs: int = 1
    metrics_path: str = "metrics.jsonl"
    log_every: int = 5               # ref train.py:130
    # --- multi-host failure detection (parallel/heartbeat.py) -------------
    # > 0 starts a per-process heartbeat (written into checkpoint_dir,
    # which multi-host checkpointing requires to be shared storage) and a
    # per-epoch watchdog scan; a dead/stalled peer raises PeerFailure so
    # the job restarts and resumes from the last epoch checkpoint instead
    # of hanging in a collective. 0 = off (single-host default).
    heartbeat_interval: float = 0.0
    # a peer whose last beat is older than this is dead (host crash);
    # one whose STEP hasn't advanced for 4x this is wedged (hung
    # collective) — both fail loudly.
    heartbeat_stale_after: float = 120.0
