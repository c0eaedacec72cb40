"""Two-pass weighted-SVD registration loss (L4 replacement; ref
deepVCP_loss.py:57-121).

Pipeline: Kabsch solve #1 on (keypoints, predicted VCPs) -> per-point
residual to the first fit -> keep the best `inlier_ratio` fraction ->
Kabsch solve #2 on the inlier subset of the ORIGINAL correspondences ->
alpha-blended L1 + mean-residual loss. Gradients flow through both SVDs and
the top-k gathers, as in the reference.

Reference defects fixed here:
- D5: the reflection fix is applied inside ops.kabsch (the reference
  computes the det-sign matrix but never uses it, deepVCP_loss.py:36-40).
- D10: the reference's second solve fits x_in against y_pred1_in where
  y_pred1 = R1 x + t1 is an *exact rigid transform of x* — so it provably
  returns (R1, t1) unchanged and the trimming never affects the pose
  (deepVCP_loss.py:81-85). Its inlier score also needs ground truth
  (1-NN against y_true, deepVCP_loss.py:70-72), which makes the solver
  unusable at inference. Here the score is the ground-truth-free residual
  to the first fit (classic trimmed-ICP) and the second solve uses the
  inlier subset of the original predictions, so pass 2 actually refines
  and `svd_refine` doubles as the inference-time pose solver.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from deepvcp.ops import apply_rigid, kabsch


class RegistrationResult(NamedTuple):
    loss: jax.Array        # scalar
    R: jax.Array           # [B, 3, 3] refined rotation
    t: jax.Array           # [B, 3] refined translation
    l1: jax.Array          # scalar: alpha term
    mean_residual: jax.Array  # scalar: (1 - alpha) term
    vcp_l1: jax.Array      # scalar: direct per-keypoint VCP error term
    rot_fro: jax.Array     # scalar: rotation Frobenius error term


class RefineResult(NamedTuple):
    R: jax.Array           # [B, 3, 3]
    t: jax.Array           # [B, 3]
    x_in: jax.Array        # [B, N', 3] inlier source points
    y_in: jax.Array        # [B, N', 3] inlier predicted correspondences
    inlier_idx: jax.Array  # [B, N'] indices into N


def svd_refine(
    x: jax.Array,
    y_pred: jax.Array,
    inlier_ratio: float = 0.8,
    weights: Optional[jax.Array] = None,
) -> RefineResult:
    """Two-pass trimmed Kabsch solve (ground-truth-free).

    Args:
        x: [B, N, 3] source keypoints.
        y_pred: [B, N, 3] predicted corresponding points.
        weights: optional per-point saliency for weighted Kabsch (the
            paper's weighted solve; the reference is unweighted).
    Returns:
        RefineResult with the refined (R, t) and the inlier subset.
    """
    N = x.shape[-2]
    R1, t1 = kabsch(x, y_pred, weights)
    y1 = apply_rigid(x, R1, t1)

    # Inlier score: residual of each predicted correspondence to the first
    # rigid fit; keep the best `inlier_ratio` (ref keeps 80%,
    # deepVCP_loss.py:76).
    resid = jnp.sum(jnp.square(y_pred - y1), axis=-1)        # [B, N]
    num_in = max(int(N * inlier_ratio), 3)
    _, in_idx = jax.lax.top_k(-resid, num_in)                # [B, N']

    take = lambda a: jnp.take_along_axis(a, in_idx[..., None], axis=-2)
    x_in, y_in = take(x), take(y_pred)
    w_in = (
        jnp.take_along_axis(weights, in_idx, axis=-1)
        if weights is not None
        else None
    )
    R2, t2 = kabsch(x_in, y_in, w_in)
    return RefineResult(R=R2, t=t2, x_in=x_in, y_in=y_in, inlier_idx=in_idx)


def deepvcp_loss(
    x: jax.Array,
    y_pred: jax.Array,
    R_true: jax.Array,
    t_true: jax.Array,
    alpha: float = 0.5,
    inlier_ratio: float = 0.8,
    weights: Optional[jax.Array] = None,
    vcp_weight: float = 0.0,
    rot_weight: float = 0.0,
) -> RegistrationResult:
    """alpha * L1(y_true_in, y2) + (1 - alpha) * |mean(y2 - y_true_in)|
    (ref deepVCP_loss.py:105-121), evaluated on the trimmed inlier set with
    y2 the second-pass fit of the inliers.

    `vcp_weight > 0` adds the DeepVCP paper's loss1 (its Eq. 5): the mean
    per-keypoint L1 between the predicted VCP and the ground-truth
    corresponding point. The reference implementation only supervises the
    rigid FIT of the VCPs (y2 = R2 x + t2), so per-point correspondence
    errors that average out in the solve receive no gradient — the direct
    term is a far stronger training signal for the CPG logits. Default 0
    keeps exact reference-loss semantics.

    `rot_weight > 0` adds an EXPLICIT rotation term on the SOLVED pose:
    mean Frobenius norm ||R2 - R_true||_F = 2*sqrt(2)*|sin(theta/2)|
    ~ sqrt(2)*theta — linear in the geodesic angle (L1-like; the arccos geodesic
    itself has an unbounded gradient at zero error). Motivation
    (round-5 campaigns r5c/r5e): at KITTI scale the point-space terms
    are TRANSLATION-dominated — a 0.4 deg rotation error displaces a
    25 m-range cloud by ~0.17 m but the supervised inlier keypoints by
    far less than their own noise, so training plateaus at 0.27-0.9 deg
    while RTE reaches millimeters. The rotation term re-weights exactly
    the component the geometry under-supervises. Gradients flow through
    the second SVD solve into the VCPs.

    Args:
        x: [B, N, 3] source keypoints.
        y_pred: [B, N, 3] predicted VCPs.
        R_true: [B, 3, 3]; t_true: [B, 3] ground-truth pose.
    """
    ref = svd_refine(x, y_pred, inlier_ratio, weights)
    y2 = apply_rigid(ref.x_in, ref.R, ref.t)
    y_true_in = apply_rigid(ref.x_in, R_true, t_true)
    l1 = jnp.mean(jnp.abs(y_true_in - y2))
    mean_res = jnp.abs(jnp.mean(y2 - y_true_in))
    vcp_l1 = jnp.mean(jnp.abs(apply_rigid(x, R_true, t_true) - y_pred))
    # sqrt(sum^2 + eps): the Frobenius norm's gradient is bounded and
    # smooth at zero rotation error (unlike the arccos geodesic)
    rot_fro = jnp.mean(jnp.sqrt(
        jnp.sum(jnp.square(ref.R - R_true), axis=(-2, -1)) + 1e-12))
    loss = (alpha * l1 + (1.0 - alpha) * mean_res
            + vcp_weight * vcp_l1 + rot_weight * rot_fro)
    return RegistrationResult(
        loss=loss, R=ref.R, t=ref.t, l1=l1, mean_residual=mean_res,
        vcp_l1=vcp_l1, rot_fro=rot_fro,
    )
