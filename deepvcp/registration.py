"""The framework's inference contract:

    register(src_cloud, tgt_cloud, init_pose) -> (R, t, keypoints, vcps, diag)

This is the capability the reference only exposes implicitly through
vis_utils.py:79-96 (forward + deepVCP_loss to extract (R_pred, t_pred) —
which needs the ground-truth pose because its solver's outlier scoring is
supervised, defect D10). Here the pose solve is ground-truth-free
(loss/registration.py `svd_refine`), so registration works on unlabeled
cloud pairs.
"""

from __future__ import annotations

import warnings
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp

from deepvcp.config import DeepVCPConfig
from deepvcp.engine import pooling_engine
from deepvcp.loss.registration import svd_refine
from deepvcp.models import DeepVCP


class RegistrationOutput(NamedTuple):
    R: jax.Array             # [B, 3, 3] estimated rotation
    t: jax.Array             # [B, 3] estimated translation
    keypoints: jax.Array     # [B, K, 3] selected source keypoints
    vcps: jax.Array          # [B, K, 3] predicted corresponding points
    inlier_idx: jax.Array    # [B, K'] inlier keypoint indices
    saliency: jax.Array      # [B, N] per-point saliency
    scores: jax.Array        # [B, refine_iters + 1] alignment score of the
                             # init pose (col 0) and each iteration's
                             # candidate pose; the returned (R, t) realizes
                             # the row-wise minimum (see Registrar guard)


class Registrar:
    """Jitted end-to-end registration with a trained model."""

    def __init__(
        self,
        cfg: DeepVCPConfig,
        variables: Any,
        inlier_ratio: float = 0.8,
        use_saliency_weights: bool = False,
        refine_iters: int = 1,
        guard: bool = True,
    ):
        """refine_iters > 1 re-runs the network with the best pose so far
        as the warm start (all iterations inside one jitted call),
        extending the basin of attraction: the candidate grid only reaches
        +/-search_radius around the init (the centered default; the
        reference's asymmetric grid reaches search_radius + voxel_len/2 on
        the negative side only, defect D12).

        CONVERGENCE CAVEAT (measured): iteration only helps when the model
        was TRAINED on jittered warm starts (TrainConfig.init_rot_jitter_deg
        / init_translation="gt" / init_trans_jitter — the residual mode).
        The reference trains on exact ground-truth inits (train.py:104-105);
        for models trained that way the round-3 Q4 sweep measured
        DIVERGENCE (GT-free RRE 20.6 -> 54.1 -> 78.1 deg over 3 iters,
        artifacts/campaign_r3c/summary.json) because any slightly-wrong
        init is out of the training distribution. Residual-mode training
        makes each pass a contraction of init error, which is what
        iteration needs.

        `guard` (default on) makes refinement non-worsening regardless of
        the training mode: every candidate pose — including the caller's
        init — is scored by the trimmed mean 1-NN distance of the
        transformed source keypoints into the target cloud (GT-free, and
        comparable across iterations because the keypoints are
        init-independent), and an iteration's pose is accepted per batch
        element only if it beats the best score so far; the next iteration
        warm-starts from the best-so-far pose. All scores are returned in
        RegistrationOutput.scores ([B, refine_iters + 1], col 0 = init).

        Cost note: the loop is unrolled into one jitted graph, so traced
        HLO (and compile time) grows ~linearly with refine_iters; the
        pose-independent prefix (both FE passes, keypoint selection) is
        re-emitted per iteration and deduped by XLA CSE, not by us. Keep
        refine_iters small (1-3). The guard adds one [B, K, N] distance
        tile per iteration — noise next to the forward."""
        self.cfg = cfg
        self.model = DeepVCP(cfg=cfg)
        self.variables = jax.device_put(variables)
        self.inlier_ratio = inlier_ratio
        self.use_saliency_weights = use_saliency_weights
        if refine_iters < 1:
            raise ValueError(f"refine_iters must be >= 1, got {refine_iters}")
        self.refine_iters = refine_iters
        self.guard = guard

        # Continuous extent monitor (the one-time host preflight gates on
        # the FIRST batch, so a long-lived Registrar later fed
        # differently-scaled clouds would get no warning). The actual
        # extent is reduced IN-GRAPH and shipped through an async
        # jax.debug.callback — no host sync on the hot path — and the
        # monitor re-warns whenever the extent moves >1.5x past the
        # declared scale or materially (>1.5x) away from the last warned
        # value.
        declared = cfg.resolve().spatial_extent
        self._warned_extent: Optional[float] = None

        def _extent_monitor(actual):
            actual = float(actual)
            if actual <= 1.5 * declared:
                return
            last = self._warned_extent
            if last is not None and (last / 1.5) < actual < (last * 1.5):
                return
            self._warned_extent = actual
            warnings.warn(
                f"cloud extent {actual:.1f} exceeds cfg.spatial_extent="
                f"{declared:g}: candidate-KNN selection precision and the "
                f"banded/windowed neighbor windows are sized for the "
                f"declared extent — set spatial_extent to the real cloud "
                f"scale",
                stacklevel=2,
            )

        self._extent_monitor = _extent_monitor

        def _score(kp, tgt_xyz, R, t):
            """Trimmed mean 1-NN distance of the posed keypoints into the
            target cloud: the GT-free acceptance metric. The keypoint set
            is pose-independent (source branch only), so scores of
            different candidate poses are directly comparable."""
            from deepvcp.ops import apply_rigid, square_distance

            y = apply_rigid(kp, R, t)                       # [B, K, 3]
            nn_d2 = jnp.min(square_distance(y, tgt_xyz), axis=-1)  # [B, K]
            k_in = max(int(nn_d2.shape[-1] * inlier_ratio), 3)
            neg, _ = jax.lax.top_k(-nn_d2, k_in)
            return jnp.sqrt(jnp.mean(jnp.maximum(-neg, 0.0), axis=-1))

        def _register(variables, src, tgt, R_init, t_init):
            xyz = src[..., :3]
            ext = jnp.max(jnp.max(xyz, axis=-2) - jnp.min(xyz, axis=-2))
            jax.debug.callback(_extent_monitor, ext)
            tgt_xyz = tgt[..., :3]
            R_best, t_best = R_init, t_init
            score_best = None
            scores = []
            for _ in range(refine_iters):
                kp, vcp, aux = self.model.apply(
                    variables, src, tgt, R_best, t_best, train=False
                )
                if score_best is None:  # score the caller's init once
                    score_best = _score(kp, tgt_xyz, R_init, t_init)
                    scores.append(score_best)
                weights = (
                    aux["keypoint_saliency"] if use_saliency_weights else None
                )
                ref = svd_refine(kp, vcp, inlier_ratio, weights)
                if guard:
                    s = _score(kp, tgt_xyz, ref.R, ref.t)
                    scores.append(s)
                    better = s < score_best                 # [B]
                    R_best = jnp.where(better[:, None, None], ref.R, R_best)
                    t_best = jnp.where(better[:, None], ref.t, t_best)
                    score_best = jnp.minimum(s, score_best)
                else:
                    R_best, t_best = ref.R, ref.t
                    score_best = _score(kp, tgt_xyz, R_best, t_best)
                    scores.append(score_best)
            return RegistrationOutput(
                R=R_best,
                t=t_best,
                keypoints=kp,
                vcps=vcp,
                inlier_idx=ref.inlier_idx,
                saliency=aux["saliency"],
                scores=jnp.stack(scores, axis=-1),
            )

        self._fn = jax.jit(_register)

    def __call__(
        self,
        src: jax.Array,
        tgt: jax.Array,
        R_init: Optional[jax.Array] = None,
        t_init: Optional[jax.Array] = None,
    ) -> RegistrationOutput:
        """src/tgt: [B, N, 3(+3)] channels-last clouds. init pose defaults
        to identity."""
        self._check_extent(src)
        return self._fn(self.variables, src, tgt,
                        *self._init_pose(src, R_init, t_init))

    def lower(self, src, tgt, R_init=None, t_init=None):
        """The jitted registration lowered for these inputs (for
        `.compile().memory_analysis()` and cost analysis)."""
        return self._fn.lower(self.variables, src, tgt,
                              *self._init_pose(src, R_init, t_init))

    @staticmethod
    def _init_pose(src, R_init, t_init):
        B = src.shape[0]
        if R_init is None:
            R_init = jnp.broadcast_to(jnp.eye(3, dtype=src.dtype), (B, 3, 3))
        if t_init is None:
            t_init = jnp.zeros((B, 3), dtype=src.dtype)
        return R_init, t_init

    def _check_extent(self, src) -> None:
        """One-time data preflight, outside jit (round-2 review findings):

        1. extent guard — the bf16 candidate-KNN selection gate and window
           sizing key off cfg.spatial_extent, a DECLARED scale; a user
           feeding raw KITTI clouds (~100 m) at the default extent (20)
           silently keeps bf16 selection with exactly the ranking error the
           gate exists to avoid;
        2. slab-occupancy audit — window_for assumes uniform density along
           the sort axis; on density-gradient clouds (real velodyne: ~100x)
           the static window under-covers over-dense slabs. Wherever a
           static window runs (the windowed engine, and the banded engine
           when deepvcp.engine picks the XLA band), audit the actual
           occupancy per SA radius and suggest the safety factor that
           would cover it."""
        if getattr(self, "_extent_checked", False):
            return
        self._extent_checked = True
        import numpy as np

        from deepvcp.ops.neighbors import (
            slab_occupancy_stats,
            window_for,
        )

        cfg = self.cfg.resolve()
        xyz = np.asarray(src[..., :3])
        actual = float((xyz.max(axis=-2) - xyz.min(axis=-2)).max())
        declared = cfg.spatial_extent
        if actual > 1.5 * declared:
            self._warned_extent = actual  # don't double-warn via monitor
            warnings.warn(
                f"cloud extent {actual:.1f} exceeds cfg.spatial_extent="
                f"{declared:g}: candidate-KNN selection precision and the "
                f"banded/windowed neighbor windows are sized for the "
                f"declared extent — set spatial_extent to the real cloud "
                f"scale (bf16 selection auto-disables above "
                f"{cfg.knn_select_f32_extent:g})",
                stacklevel=3,
            )
        # the GPU pooling kernel sweeps exact slabs; only the static
        # windows depend on window_for coverage
        windowed_paths = cfg.neighbor_method == "windowed" or (
            cfg.neighbor_method == "banded"
            and pooling_engine() == "xla_band"
        )
        if not windowed_paths:
            return
        N = xyz.shape[-2]
        worst = 0.0
        for layer in cfg.sa_layers:
            w = window_for(
                N, layer.radius, cfg.spatial_extent, cfg.window_safety
            )
            if w >= N:
                continue
            occ = slab_occupancy_stats(xyz, layer.radius)
            if occ["max"] > w:
                # safety' such that window_for's expected*safety' covers
                # the measured occupancy (scaling the CURRENT safety by
                # occ/w under-estimates when w was floored at the
                # 128 minimum — review finding)
                expected = N * min(
                    2.0 * layer.radius / max(cfg.spatial_extent, 1e-6), 1.0
                )
                worst = max(worst, occ["max"] / max(expected, 1e-6))
        if worst > 0:
            warnings.warn(
                f"static neighbor windows under-cover this cloud's density "
                f"peaks (slab occupancy exceeds the window sized by "
                f"window_safety={cfg.window_safety:g}); over-dense queries "
                f"lose in-radius neighbors (zero-hit rows are masked, not "
                f"polluted). Raise window_safety to ~{worst:.1f}, or use "
                f"neighbor_method='dense'",
                stacklevel=3,
            )

    def stream(self, pairs, depth: int = 4):
        """Pipelined registration over an iterable of (src, tgt[, R_init,
        t_init]) tuples: keeps up to `depth` jitted calls in flight so
        dispatch/host latency overlaps device compute — the steady-state
        serving mode. Yields RegistrationOutput in input order, each
        ready on the device.
        """
        from collections import deque

        inflight: deque = deque()

        def drain():
            out = inflight.popleft()
            jax.block_until_ready(out.R)
            return out

        for pair in pairs:
            inflight.append(self(*pair))
            if len(inflight) >= depth:
                yield drain()
        while inflight:
            yield drain()


class CascadeRegistrar:
    """Coarse-to-fine registration: a sequence of Registrar stages, each
    warm-started from the previous stage's pose.

    Why a cascade: the CPG candidate grid trades REACH (search_radius)
    against RESOLUTION (voxel_len) at a fixed candidate count — one grid
    cannot both capture a large init error and localize the VCP finely.
    At KITTI scale the coarse grid (r=1.0, s=0.4 m) has a measured
    soft-argmax rotation floor of 0.3-0.4 deg, while the fine grid
    (r=0.6, s=0.2) alone clips rotation supervision whenever the init
    rotation error exceeds ~1.6 deg at the 25 m lever arm (0.7 m reach;
    campaign_r4e regressed RRE to 1.17 deg for exactly this reason).
    Chaining them — coarse pass contracts into the fine grid's basin,
    fine pass localizes below the coarse floor — was measured at
    ModelNet scale in campaign_r4 part 1 (1.93 deg/0.025 vs 2.43/0.058
    coarse-only) and is the round-5 KITTI-scale headline recipe.

    The reference has no counterpart (its one grid is fixed at r=1.0,
    s=0.4, deepVCP.py:76-77, and its eval initializes at ground truth).

    Each stage keeps its own non-worsening guard, and stage i+1 scores
    stage i's pose as its own init (col 0 of its score block), so the
    cascade never returns a pose worse than the incoming init under any
    stage's keypoint metric. `scores` concatenates all stages' blocks:
    [B, sum_i (refine_iters_i + 1)].

    Stages may differ in grid geometry (and even trained weights) but
    must share the input contract (num_points, use_normal, scale).
    """

    def __init__(self, stages):
        if not stages:
            raise ValueError("CascadeRegistrar needs at least one stage")
        for a, b in zip(stages[:-1], stages[1:]):
            if (a.cfg.num_points, a.cfg.use_normal) != (
                    b.cfg.num_points, b.cfg.use_normal):
                raise ValueError(
                    "cascade stages disagree on the input contract: "
                    f"{(a.cfg.num_points, a.cfg.use_normal)} vs "
                    f"{(b.cfg.num_points, b.cfg.use_normal)}")
        self.stages = list(stages)

    @property
    def cfg(self):
        """The FINAL stage's config (what the output pose was solved
        under) — lets cascade and plain Registrar interchange in eval
        harnesses."""
        return self.stages[-1].cfg

    def __call__(
        self,
        src: jax.Array,
        tgt: jax.Array,
        R_init: Optional[jax.Array] = None,
        t_init: Optional[jax.Array] = None,
    ) -> RegistrationOutput:
        out = None
        score_blocks = []
        for reg in self.stages:
            out = reg(src, tgt, R_init, t_init)
            R_init, t_init = out.R, out.t
            score_blocks.append(out.scores)
        return out._replace(scores=jnp.concatenate(score_blocks, axis=-1))

    def stream(self, pairs, depth: int = 4):
        """Pipelined cascade over an iterable of pair tuples (see
        Registrar.stream): all stages of up to `depth` pairs stay in
        flight, so stage-1 compute of pair i overlaps stage-2 compute of
        pair i-1 on the device queue."""
        from collections import deque

        inflight: deque = deque()
        for pair in pairs:
            inflight.append(self(*pair))
            if len(inflight) >= depth:
                out = inflight.popleft()
                jax.block_until_ready(out.R)
                yield out
        while inflight:
            out = inflight.popleft()
            jax.block_until_ready(out.R)
            yield out


class RoutedRegistrar:
    """Mixture-of-experts registration: route each input pair to the
    specialist checkpoint trained on its distribution.

    The round-4/5 campaigns settled that one set of weights cannot serve
    both uniform-density and lidar-like clouds at ModelNet scale (the
    lidar-heavy fine-tune wins lidar 2.12 deg but regresses uniform to
    5.6; two 50/50-mix fine-tunes at different learning rates landed
    between the specialists on BOTH sets — campaign_r5 G1 /
    campaign_r5d G2). The product answer is routing, not retraining:
    the specialists share one architecture and config, so selecting the
    VARIABLES per input costs one tiny distance tile plus a parameter-
    tree select, both in-graph (no host sync, one compiled program).

    Router statistic: the coefficient of variation of 1-NN distances
    over a strided 512-point subsample — dimensionless (scale-free) and
    cleanly bimodal (measured: uniform clouds 0.51-0.58, lidar-like
    0.92-1.15 across scales 1-25 m; threshold 0.75).

    Routing granularity: ONE vote per batch (the mean statistic) — a
    single variables tree feeds the compiled program. Mixed-distribution
    batches should be split by the caller (batch elements of one
    registration call usually share a sensor anyway); use
    `route_statistic` to inspect per-cloud values.
    """

    def __init__(
        self,
        cfg: DeepVCPConfig,
        variants,
        threshold: float = 0.75,
        **registrar_kwargs,
    ):
        """variants: {"low": variables, "high": variables} — applied
        when the router statistic falls below / above `threshold`
        (low = uniform-like, high = lidar-like)."""
        if set(variants) != {"low", "high"}:
            raise ValueError(
                f"variants must have keys 'low'/'high', got "
                f"{sorted(variants)}")
        self._reg = Registrar(cfg, variants["low"], **registrar_kwargs)
        self.threshold = threshold
        lo, hi = variants["low"], variants["high"]

        def _route(src):
            from deepvcp.ops import square_distance

            xyz = src[..., :3]
            step = max(xyz.shape[-2] // 512, 1)
            sub = xyz[:, ::step][:, :512]
            d2 = square_distance(sub, sub)
            d2 = jnp.where(d2 <= 1e-12, jnp.inf, d2)  # drop self-match
            nn = jnp.sqrt(jnp.min(d2, axis=-1))
            cv = jnp.std(nn, axis=-1) / (jnp.mean(nn, axis=-1) + 1e-12)
            is_high = jnp.mean(cv) > threshold  # one vote per batch
            return jax.tree_util.tree_map(
                lambda a, b: jnp.where(is_high, b, a), lo, hi), cv

        self._route = jax.jit(_route)

    @property
    def cfg(self):
        return self._reg.cfg

    def __call__(
        self,
        src: jax.Array,
        tgt: jax.Array,
        R_init: Optional[jax.Array] = None,
        t_init: Optional[jax.Array] = None,
    ) -> RegistrationOutput:
        variables, _ = self._route(src)
        self._reg.variables = variables
        return self._reg(src, tgt, R_init, t_init)

    def route_statistic(self, src) -> jax.Array:
        """The per-cloud router statistic (diagnostics)."""
        return self._route(src)[1]
