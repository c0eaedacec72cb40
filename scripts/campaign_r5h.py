"""Round-5 campaign part H: odometry with the cascade registrar.

The round-4 odometry demo (campaign_r4b K2: accelerating 12-frame
sequence whose per-frame motion outgrows the candidate grid's reach)
measured 0.017 m mean per-frame translation error with the single-stage
kitti25 model at 2 guarded iterations. The kitti-cascade stack has 3.6x
better pairwise RTE (0.0027 vs 0.0097), so the same protocol should
show a proportional odometry gain. Identical scene construction and
seeds to K2 for comparability.

Artifacts: artifacts/campaign_r5h/. Restart-safe.
"""

from __future__ import annotations

import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from campaign_r4_common import Campaign, wait_for_device  # noqa: E402


def main():
    import jax

    TINY = os.environ.get("CAMPAIGN_TINY") == "1"
    if TINY:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from deepvcp import pretrained
    from deepvcp.data.datasets import lidar_like_cloud
    from deepvcp.odometry.pipeline import register_sequence
    from deepvcp.odometry.pose_graph import (
        absolute_trajectory_error,
        build_graph,
        chain_poses,
        optimize_pose_graph,
    )
    from deepvcp.utils.rotations import axis_angle_to_matrix

    wait_for_device()
    c = Campaign("campaign_r5h")

    N = 128 if TINY else 10000
    MAX_RANGE = 2.0 if TINY else 25.0

    if not c.done("O1_cascade_odometry"):
        try:
            if TINY:
                c.save("O1_cascade_odometry", {"skipped": "tiny mode"})
            else:
                reg = pretrained.cascade("kitti-cascade", num_points=N)
                rng = np.random.default_rng(11)     # K2's exact scene
                cloud = lidar_like_cloud(
                    rng, N, max_range=MAX_RANGE).astype(np.float32)
                F = 12
                scale = MAX_RANGE / 25.0
                R_abs = [np.eye(3, dtype=np.float32)]
                t_abs = [np.zeros(3, dtype=np.float32)]
                R_rel_true, t_rel_true = [], []
                for i in range(F - 1):
                    Rr = axis_angle_to_matrix(
                        np.array([0.0, 0.0, 1.0]), np.radians(1.5)
                    ).astype(np.float32)
                    tr_ = scale * np.array([0.8 + 0.15 * i, 0.05, 0.0],
                                           np.float32)
                    R_rel_true.append(Rr)
                    t_rel_true.append(tr_)
                    R_abs.append(Rr @ R_abs[-1])
                    t_abs.append(Rr @ t_abs[-1] + tr_)
                scans = np.stack(
                    [cloud @ Rm.T + tv for Rm, tv in zip(R_abs, t_abs)]
                ).astype(np.float32)
                R_rel_true = np.stack(R_rel_true)
                t_rel_true = np.stack(t_rel_true)

                R_est, t_est = register_sequence(reg, scans,
                                                 warm_start=True)
                terr = np.linalg.norm(t_est - t_rel_true, axis=-1)
                rerr = [float(x) for x in np.degrees(np.arccos(np.clip(
                    (np.trace(np.einsum("fab,fcb->fac", R_est,
                                        R_rel_true),
                              axis1=-2, axis2=-1) - 1) / 2, -1, 1)))]
                out = {
                    "per_frame_t_err": [round(float(x), 4) for x in terr],
                    "mean_t_err": round(float(terr.mean()), 4),
                    "max_t_err": round(float(terr.max()), 4),
                    "mean_r_err_deg": round(float(np.mean(rerr)), 3),
                    "k2_baseline_mean_t_err": 0.017,
                }
                R_gt_abs, t_gt_abs = chain_poses(
                    jnp.asarray(R_rel_true), jnp.asarray(t_rel_true))
                R_ch, t_ch = chain_poses(jnp.asarray(R_est),
                                         jnp.asarray(t_est))
                ate_chain = float(
                    absolute_trajectory_error(t_ch, t_gt_abs))
                extra = []
                for i in range(F - 2):
                    R1, t1 = R_est[i], t_est[i]
                    R2, t2 = R_est[i + 1], t_est[i + 1]
                    o = reg(jnp.asarray(scans[i:i + 1]),
                            jnp.asarray(scans[i + 2:i + 3]),
                            jnp.asarray((R2 @ R1)[None]),
                            jnp.asarray((R2 @ t1 + t2)[None]))
                    extra.append((i, i + 2, np.asarray(o.R)[0],
                                  np.asarray(o.t)[0]))
                graph = build_graph(jnp.asarray(R_est),
                                    jnp.asarray(t_est),
                                    extra_edges=extra)
                R_opt, t_opt = optimize_pose_graph(
                    graph, R_ch, t_ch, num_iters=30)
                ate_opt = float(
                    absolute_trajectory_error(t_opt, t_gt_abs))
                out["ate"] = {
                    "raw_chain": round(ate_chain, 4),
                    "pose_graph_optimized": round(ate_opt, 4),
                    "k2_baseline": {"raw_chain": 0.040,
                                    "optimized": 0.022},
                }
                c.save("O1_cascade_odometry", out)
        except Exception:
            c.save("O1_cascade_odometry", {"error": traceback.format_exc()})

    # --- O2: odometry with the rotation-tuned single-stage model ----------
    # kitti25-rot is the rotation headline (0.2365 deg pairwise); the
    # cascade run (O1) showed per-edge rotation ~1 deg dominates its
    # trajectory error. Same scene, same protocol.
    if not c.done("O2_rot_odometry") and not TINY:
        try:
            reg = pretrained.registrar("kitti25-rot", num_points=N,
                                       refine_iters=2)
            rng = np.random.default_rng(11)
            cloud = lidar_like_cloud(
                rng, N, max_range=MAX_RANGE).astype(np.float32)
            F = 12
            scale = MAX_RANGE / 25.0
            R_abs = [np.eye(3, dtype=np.float32)]
            t_abs = [np.zeros(3, dtype=np.float32)]
            R_rel_true, t_rel_true = [], []
            for i in range(F - 1):
                Rr = axis_angle_to_matrix(
                    np.array([0.0, 0.0, 1.0]), np.radians(1.5)
                ).astype(np.float32)
                tr_ = scale * np.array([0.8 + 0.15 * i, 0.05, 0.0],
                                       np.float32)
                R_rel_true.append(Rr)
                t_rel_true.append(tr_)
                R_abs.append(Rr @ R_abs[-1])
                t_abs.append(Rr @ t_abs[-1] + tr_)
            scans = np.stack(
                [cloud @ Rm.T + tv for Rm, tv in zip(R_abs, t_abs)]
            ).astype(np.float32)
            R_rel_true = np.stack(R_rel_true)
            t_rel_true = np.stack(t_rel_true)
            R_est, t_est = register_sequence(reg, scans, warm_start=True)
            terr = np.linalg.norm(t_est - t_rel_true, axis=-1)
            rerr = np.degrees(np.arccos(np.clip(
                (np.trace(np.einsum("fab,fcb->fac", R_est, R_rel_true),
                          axis1=-2, axis2=-1) - 1) / 2, -1, 1)))
            R_gt_abs, t_gt_abs = chain_poses(
                jnp.asarray(R_rel_true), jnp.asarray(t_rel_true))
            R_ch, t_ch = chain_poses(jnp.asarray(R_est),
                                     jnp.asarray(t_est))
            c.save("O2_rot_odometry", {
                "mean_t_err": round(float(terr.mean()), 4),
                "max_t_err": round(float(terr.max()), 4),
                "mean_r_err_deg": round(float(rerr.mean()), 3),
                "ate_raw_chain": round(float(
                    absolute_trajectory_error(t_ch, t_gt_abs)), 4),
                "cascade_O1": {"mean_t_err": 0.0063,
                               "mean_r_err_deg": 1.038,
                               "ate_raw_chain": 0.0226},
            })
        except Exception:
            c.save("O2_rot_odometry", {"error": traceback.format_exc()})

    print("[campaign_r5h] DONE", flush=True)


if __name__ == "__main__":
    main()
