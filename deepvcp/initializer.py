"""Global SO(3) initializer: coarse alignment for unrestricted rotations.

The DeepVCP network is a LOCAL refiner — its candidate grid reaches
+/-search_radius around the warm-started keypoints, and the Siamese
matching is canonicalized by the init rotation (D14), so a full-SO(3)
pair with identity init is unanswerable by construction (measured:
GT-free RRE ~136 deg on the full_so3 held set, campaign_r4 R1). The
reference shares the limitation (it evaluates from the ground-truth
pose, train.py:104-105, so the question never arises there). This
module finishes the "works on unlabeled cloud pairs" contract
(registration.py:1-10): bring any pair into the refiner's basin.

No RANSAC hypothesis loops or data-dependent control flow; everything
is a dense batched problem:

  1. subsample both clouds (FPS for coverage, ops/sampling.py) into a
     coarse and a fine target level; center about the full-cloud
     centroids (which absorb most of the translation);
  2. run coarse-level trimmed-NN Kabsch ICP from EVERY rotation of a
     FIXED super-Fibonacci grid (Alexa, CVPR 2022: near-optimal SO(3)
     covering), all hypotheses batched, chunked via `lax.map`;
  3. rescore every converged hypothesis at the fine level, fine-ICP
     the top_p survivors, return the best final score.

See so3_global_init's docstring for why there is no cheap score-sweep
pre-ranking stage (three measured failure modes).

The returned pose feeds Registrar / CascadeRegistrar as (R_init,
t_init); their guard then scores it as column 0, so a pathological
init can never worsen the cascade's output.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from deepvcp.ops.distance import square_distance
from deepvcp.ops.kabsch import kabsch
from deepvcp.ops.sampling import farthest_point_sample


class GlobalInit(NamedTuple):
    R: jax.Array       # [B, 3, 3] coarse rotation
    t: jax.Array       # [B, 3] coarse translation
    score: jax.Array   # [B] final trimmed-NN score of the chosen pose


def super_fibonacci_rotations(n: int, dtype=jnp.float32) -> jax.Array:
    """n near-uniformly covering rotations [n, 3, 3] (super-Fibonacci
    spirals, Alexa CVPR 2022 — the S^3 analogue of the golden-ratio
    sphere spiral; deterministic, no RNG)."""
    import numpy as np

    # host-side f64 (the grid is a jit-closed constant; device f32
    # would wobble the quaternion normalization at large n)
    s = np.arange(n, dtype=np.float64) + 0.5
    phi = 1.533751168755204288118041  # psi: the positive root of x^4=x+4
    r = np.sqrt(s / n)
    rr = np.sqrt(1.0 - s / n)
    alpha = 2.0 * np.pi * s / np.sqrt(2.0)
    beta = 2.0 * np.pi * s / phi
    q = np.stack([r * np.sin(alpha), r * np.cos(alpha),
                  rr * np.sin(beta), rr * np.cos(beta)], axis=-1)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1).reshape(n, 3, 3)
    return jnp.asarray(R, dtype=dtype)


def _trimmed_score(d2_min: jax.Array, keep: int) -> jax.Array:
    """Mean of the `keep` smallest per-row squared NN distances
    (robust to partial overlap). d2_min: [..., S] -> [...]."""
    neg, _ = jax.lax.top_k(-d2_min, keep)
    return jnp.mean(jnp.maximum(-neg, 0.0), axis=-1)


@functools.partial(
    jax.jit,
    static_argnames=("n_rotations", "n_src", "n_tgt", "n_coarse",
                     "top_p", "icp_iters", "icp_coarse_iters",
                     "inlier_ratio", "sweep_chunk"),
)
def so3_global_init(
    src: jax.Array,
    tgt: jax.Array,
    n_rotations: int = 4096,
    n_src: int = 128,
    n_tgt: int = 4096,
    n_coarse: int = 256,
    top_p: int = 64,
    icp_iters: int = 4,
    icp_coarse_iters: int = 3,
    inlier_ratio: float = 0.7,
    sweep_chunk: int = 64,
) -> GlobalInit:
    """Coarse global alignment of [B, N, 3(+C)] cloud pairs.

    DESIGN (settled by three measured failures of sweep-then-refine,
    round-5 campaign W4): a correspondence-FREE score cannot rank the
    true rotation above the symmetry twins of a near-symmetric cloud
    support (a uniform cube maps to itself under the octahedral
    group), and on dense clouds its basin (~arcsin(NN spacing /
    cloud_rms)) is far narrower than any affordable rotation grid's
    covering radius — worse, boundary-biased FPS subsampling made the
    near-truth grid point score BELOW the random floor (rank 396 of
    4096, measured). So there is no sweep pre-ranking at all:

      1. coarse-level trimmed-NN Kabsch ICP runs on EVERY grid
         rotation (n_rotations=4096, covering ~13.5 deg; coarse level
         n_coarse=256 FPS points whose ~0.31 spacing gives an ~18 deg
         ICP basin > covering radius), chunked over hypotheses — some
         hypothesis always converges into the true optimum;
      2. the FINE level (n_tgt=4096, clamped to N) rescores every
         converged hypothesis: exact point correspondences are the
         only signal that separates the true class from its twins;
      3. the top_p fine-scored survivors get fine-level ICP and the
         best final score wins.

    The coarse level is the FPS prefix of the fine level (FPS orderings
    are nested), so one FPS pass serves both. Everything is dense,
    static-shaped, chunked via lax.map — ~15 GFLOP per batch element
    at the defaults.
    """
    src_xyz = src[..., :3]
    tgt_xyz = tgt[..., :3]
    B = src_xyz.shape[0]
    n_src = min(n_src, src_xyz.shape[-2])
    n_tgt = min(n_tgt, tgt_xyz.shape[-2])
    n_coarse = min(n_coarse, n_tgt)

    # 1-2: subsample (FPS: coverage beats uniform for scoring) + center
    s_idx = farthest_point_sample(src_xyz, n_src)           # [B, S]
    t_idx = farthest_point_sample(tgt_xyz, n_tgt)           # [B, T]
    s_sub = jnp.take_along_axis(src_xyz, s_idx[..., None], axis=-2)
    t_sub = jnp.take_along_axis(tgt_xyz, t_idx[..., None], axis=-2)
    s_mean = jnp.mean(src_xyz, axis=-2, keepdims=True)      # full-cloud
    t_mean = jnp.mean(tgt_xyz, axis=-2, keepdims=True)      # centroids
    s_c = s_sub - s_mean
    t_c = t_sub - t_mean                                    # fine level
    t_cc = t_c[:, :n_coarse]                                # coarse level
    keep = max(int(n_src * inlier_ratio), 3)

    grid = super_fibonacci_rotations(n_rotations, src_xyz.dtype)

    def icp_stage(R0, t0, t_lvl, iters):
        """Batched trimmed-NN Kabsch on [B, P, ...] hypothesis sets."""
        P = R0.shape[1]
        s_bc = jnp.broadcast_to(s_c[:, None], (B, P) + s_c.shape[1:])

        def icp_step(carry, _):
            R, t = carry
            y = jnp.einsum("bpsj,bpij->bpsi", s_bc, R) + t[..., None, :]
            d2 = square_distance(
                y.reshape(B * P, n_src, 3),
                jnp.repeat(t_lvl, P, axis=0),
            ).reshape(B, P, n_src, -1)
            nn_d2 = jnp.min(d2, axis=-1)
            nn_ix = jnp.argmin(d2, axis=-1)                 # [B, P, S]
            corr = jnp.take_along_axis(
                jnp.broadcast_to(
                    t_lvl[:, None], d2.shape[:2] + t_lvl.shape[1:]),
                nn_ix[..., None], axis=-2)                  # [B, P, S, 3]
            # trimmed weights: keep the closest `keep` correspondences
            thresh = -jax.lax.top_k(-nn_d2, keep)[0][..., -1:]
            w = (nn_d2 <= thresh).astype(src_xyz.dtype)
            Rn, tn = kabsch(
                s_bc.reshape(B * P, n_src, 3),
                corr.reshape(B * P, n_src, 3),
                weights=w.reshape(B * P, n_src),
            )
            return (Rn.reshape(B, P, 3, 3), tn.reshape(B, P, 3)), None

        (Rf, tf), _ = jax.lax.scan(icp_step, (R0, t0), None,
                                   length=iters)
        return Rf, tf

    def score_all(R, t, t_lvl):
        """Trimmed fine/coarse score of [B, P, ...] hypotheses."""
        P = R.shape[1]
        s_bc = jnp.broadcast_to(s_c[:, None], (B, P) + s_c.shape[1:])
        y = jnp.einsum("bpsj,bpij->bpsi", s_bc, R) + t[..., None, :]
        d2 = square_distance(
            y.reshape(B * P, n_src, 3), jnp.repeat(t_lvl, P, axis=0)
        ).reshape(B, P, n_src, -1)
        return _trimmed_score(jnp.min(d2, axis=-1), keep)   # [B, P]

    # 3: coarse ICP on EVERY grid rotation, chunked over hypotheses.
    # The coarse basin (~18 deg) exceeds the grid's covering radius
    # (~13.5 deg), so some chunk member always converges to the true
    # optimum — no sweep pre-ranking needed (and none works: a
    # correspondence-free score cannot rank the true class above
    # symmetry twins of a near-symmetric cloud support).
    cg = min(sweep_chunk, n_rotations)
    n_chunks = -(-n_rotations // cg)
    pad = n_chunks * cg - n_rotations
    grid_p = jnp.concatenate(
        [grid, jnp.broadcast_to(jnp.eye(3, dtype=grid.dtype),
                                (pad, 3, 3))], axis=0) if pad else grid

    def coarse_chunk(g):                                    # [cg, 3, 3]
        R0 = jnp.broadcast_to(g[None], (B, cg, 3, 3))
        t0 = jnp.zeros((B, cg, 3), src_xyz.dtype)
        Rc, tc = icp_stage(R0, t0, t_cc, icp_coarse_iters)
        # 4: FINE-level rescore breaks symmetry ties — only exact point
        # correspondences distinguish the true class from its twins
        sc = score_all(Rc, tc, t_c)
        return Rc, tc, sc

    Rc, tc, sc = jax.lax.map(
        coarse_chunk, grid_p.reshape(n_chunks, cg, 3, 3))
    Rc = jnp.moveaxis(Rc, 1, 0).reshape(B, n_chunks * cg, 3, 3)
    tc = jnp.moveaxis(tc, 1, 0).reshape(B, n_chunks * cg, 3)
    sc = jnp.moveaxis(sc, 1, 0).reshape(B, n_chunks * cg)
    sc = jnp.where(
        jnp.arange(n_chunks * cg) < n_rotations, sc, jnp.inf)
    _, best = jax.lax.top_k(-sc, top_p)                     # [B, P]
    R0 = jnp.take_along_axis(
        Rc, best[..., None, None].repeat(3, -2).repeat(3, -1), axis=1)
    t0 = jnp.take_along_axis(tc, best[..., None].repeat(3, -1), axis=1)

    # 5: fine-level ICP on the survivors + final scoring
    Rf, tf = icp_stage(R0, t0, t_c, icp_iters)
    final = score_all(Rf, tf, t_c)                          # [B, P]
    pick = jnp.argmin(final, axis=-1)                       # [B]
    Rb = jnp.take_along_axis(
        Rf, pick[:, None, None, None].repeat(3, -2).repeat(3, -1), axis=1
    )[:, 0]
    tb = jnp.take_along_axis(tf, pick[:, None, None].repeat(3, -1),
                             axis=1)[:, 0]
    sb = jnp.take_along_axis(final, pick[:, None], axis=1)[:, 0]

    # un-center: x_tgt = R (x_src - s_mean) + t + t_mean
    t_full = (tb + t_mean[:, 0]
              - jnp.einsum("bj,bij->bi", s_mean[:, 0], Rb))
    return GlobalInit(R=Rb, t=t_full,
                      score=jnp.sqrt(jnp.maximum(sb, 0.0)))
