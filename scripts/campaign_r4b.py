"""Round-4 campaign, part 2: KITTI-scale systems run + the round-3 leftovers.

VERDICT.md "Next round" items #3 and #5:

  K1  KITTI-scale end-to-end training: lidar-like clouds at max_range=25
      (spatial extent ~50+), cfg.spatial_extent=55 — above
      knn_select_f32_extent, so the f32 candidate-selection gate ENGAGES
      (recorded in the summary), window sizing runs at realistic scale,
      and the residual recipe trains in meters; GT-free eval + guarded
      refinement sweep on held-out small-motion pairs;
  K2  odometry demo with the trained K1 model on an accelerating
      synthetic sequence whose per-frame motion grows BEYOND candidate
      grid reach: constant-velocity warm start vs identity init, then
      pose-graph optimization with skip-frame loop-closure edges —
      ATE raw-chain vs graph-optimized (the with/without-graph delta the
      round-3 demo never measured);
  Q5  trained-model engine delta (round-3 unfinished): train a windowed-
      engine model under the residual recipe at ModelNet scale, evaluate
      THE SAME weights under windowed AND dense engines;
  Q7  roofline: profile_stages at B=1 and B=8 — the batch-scaling
      attribution (which stage's per-pair cost grows with B).

Artifacts: artifacts/campaign_r4b/. Restart-safe like part 1.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from campaign_r4_common import (  # noqa: E402
    Campaign,
    load_trained,
    make_data,
    registrar_eval,
    residual_tcfg,
    train_model,
    variables_of,
    wait_for_device,
)


def main():
    import jax

    TINY = os.environ.get("CAMPAIGN_TINY") == "1"
    if TINY:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from deepvcp import DeepVCPConfig
    from deepvcp.data import LidarLikeDataset, batch_iterator

    wait_for_device()
    c = Campaign("campaign_r4b")

    # ---- K1: KITTI-scale training -------------------------------------------
    if TINY:
        N, MAX_RANGE, EXTENT = 128, 2.0, 5.0
        n_train, n_held = 4, 2
        BUDGET_K1, BUDGET_Q5 = 0.2, 0.2
    else:
        N, MAX_RANGE, EXTENT = 10000, 25.0, 55.0
        n_train, n_held = 256, 16
        BUDGET_K1, BUDGET_Q5 = 25.0, 12.0

    if TINY:
        cfg_kitti = dataclasses.replace(
            DeepVCPConfig.tiny(num_points=N, use_normal=False),
            neighbor_method="banded", spatial_extent=EXTENT, band_tile=64,
        )
    else:
        cfg_kitti = DeepVCPConfig(
            num_points=N, use_normal=False, spatial_extent=EXTENT
        )
    # translations in METERS (the reference's U[-1,1]^3, train.py /
    # KITTIDataset.py, is meter-scale for velodyne too); grid reach stays
    # the reference's r=1.0 m, s=0.4 m.
    train_k = LidarLikeDataset(num_clouds=n_train, num_points=N,
                               max_range=MAX_RANGE, seed=10)
    held_k = {
        "lidar25_small": LidarLikeDataset(
            num_clouds=n_held, num_points=N, max_range=MAX_RANGE, seed=110,
            max_rotation_deg=5.0, max_translation=0.5),
    }
    tcfg_k = dataclasses.replace(
        residual_tcfg(rot_jitter_deg=6.0, trans_jitter=0.5),
    )
    steps_per_epoch = len(train_k)
    sample_k = next(batch_iterator(train_k, 1, epoch=0, seed=0))

    # K1 budget sizing reuses part 1's measured step time when available
    # (same arch; the KITTI-scale step only changes constants), else 90 ms
    step_ms = 90.0
    p1 = os.path.join(os.path.dirname(c.art), "campaign_r4", "summary.json")
    if os.path.exists(p1):
        with open(p1) as fh:
            step_ms = json.load(fh).get("P0_step_probe", {}).get(
                "residual_step_ms", step_ms)

    def epochs_for(budget_min, spe):
        steps = max(int(budget_min * 60e3 / step_ms), spe)
        return max(min(steps // spe, 60), 1)

    EP_K1 = epochs_for(BUDGET_K1, steps_per_epoch)
    trainer_k = None
    if c.done("K1_kitti_scale"):
        if not (c.done("K1_sweep") and c.done("K2_odometry")):
            # only consumers of the trained model are the sweep + odometry
            trainer_k = load_trained(c, "model_k1", cfg_kitti, tcfg_k,
                                     EP_K1, sample_k, steps_per_epoch)
    else:
        try:
            trainer_k, res = train_model(
                c, "model_k1", cfg_kitti, tcfg_k, EP_K1, train_k, held_k,
                sample_k, steps_per_epoch)
            res["f32_selection_engaged"] = (
                cfg_kitti.knn_select_dtype_effective is None)
            c.save("K1_kitti_scale", res)
        except Exception:
            c.save("K1_kitti_scale", {"error": traceback.format_exc()})

    if trainer_k is not None and not c.done("K1_sweep"):
        try:
            variables_k = variables_of(trainer_k)
            c.save("K1_sweep", {
                f"iters_{i}": {
                    "lidar25_small": registrar_eval(
                        cfg_kitti, variables_k, held_k["lidar25_small"], i,
                        batches=8)}
                for i in (1, 2)
            })
        except Exception:
            c.save("K1_sweep", {"error": traceback.format_exc()})

    # ---- K2: odometry with warm start + pose graph --------------------------
    if trainer_k is not None and not c.done("K2_odometry"):
        try:
            from deepvcp.data.datasets import lidar_like_cloud
            from deepvcp.odometry.pipeline import register_sequence
            from deepvcp.odometry.pose_graph import (
                absolute_trajectory_error,
                build_graph,
                chain_poses,
                optimize_pose_graph,
            )
            from deepvcp.registration import Registrar
            from deepvcp.utils.rotations import axis_angle_to_matrix

            variables_k = variables_of(trainer_k)
            rng = np.random.default_rng(11)
            cloud = lidar_like_cloud(rng, N, max_range=MAX_RANGE).astype(
                np.float32)
            # accelerating: |t| grows from well inside grid reach (1.2 m)
            # to ~2x beyond it; constant-velocity prior error stays ~0.15 m
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

            reg = Registrar(cfg_kitti, variables_k,
                            use_saliency_weights=True, refine_iters=2)
            out = {}
            est = {}
            for mode, warm in (("warm_start", True), ("identity_init",
                                                      False)):
                R_est, t_est = register_sequence(reg, scans,
                                                 warm_start=warm)
                est[mode] = (R_est, t_est)
                terr = np.linalg.norm(t_est - t_rel_true, axis=-1)
                out[mode] = {
                    "per_frame_t_err": [round(float(x), 3) for x in terr],
                    "mean_t_err": round(float(terr.mean()), 3),
                    "max_t_err": round(float(terr.max()), 3),
                }

            # ATE of the raw warm-start chain
            R_gt_abs, t_gt_abs = chain_poses(
                jnp.asarray(R_rel_true), jnp.asarray(t_rel_true))
            R_est_rel, t_est_rel = est["warm_start"]
            R_ch, t_ch = chain_poses(jnp.asarray(R_est_rel),
                                     jnp.asarray(t_est_rel))
            ate_chain = float(absolute_trajectory_error(t_ch, t_gt_abs))

            # skip-frame loop closures (i -> i+2), initialized from the
            # estimated chain composition, measured by fresh registration
            extra = []
            for i in range(F - 2):
                R1, t1 = R_est_rel[i], t_est_rel[i]
                R2, t2 = R_est_rel[i + 1], t_est_rel[i + 1]
                R_init = (R2 @ R1)[None]
                t_init = (R2 @ t1 + t2)[None]
                o = reg(jnp.asarray(scans[i:i + 1]),
                        jnp.asarray(scans[i + 2:i + 3]),
                        R_init=jnp.asarray(R_init),
                        t_init=jnp.asarray(t_init))
                extra.append((i, i + 2, np.asarray(o.R)[0],
                              np.asarray(o.t)[0]))
            graph = build_graph(jnp.asarray(R_est_rel),
                                jnp.asarray(t_est_rel), extra_edges=extra)
            R_opt, t_opt = optimize_pose_graph(graph, R_ch, t_ch,
                                               num_iters=30)
            ate_opt = float(absolute_trajectory_error(t_opt, t_gt_abs))
            out["ate"] = {
                "raw_chain": round(ate_chain, 4),
                "pose_graph_optimized": round(ate_opt, 4),
                "improvement_pct": round(
                    100 * (1 - ate_opt / max(ate_chain, 1e-9)), 1),
                "skip_edges": len(extra),
            }
            c.save("K2_odometry", out)
        except Exception:
            c.save("K2_odometry", {"error": traceback.format_exc()})

    # ---- Q5: trained-model engine delta -------------------------------------
    # REDESIGNED TWICE this round, both times on measurement:
    # 1. TRAINING windowed at N=10k runs ~170x slower than the banded
    #    step (the backward re-materializes the per-query window
    #    gathers). A 12-min budget sized from the
    #    banded probe would actually take ~33 h — the same pathology
    #    that killed round-3's model B3 in epoch 0.
    # 2. Banded-trained weights can NOT be re-evaluated under
    #    windowed/dense: the banded SA is an architectural redesign
    #    (pool after the linearity-split first layer, per-point MLP
    #    tail), with its own param tree (standalone bias0); only
    #    windowed<->dense share the gather-path architecture/params.
    # So the measurable deltas are: (a) ARCH delta — banded vs windowed
    # models trained with the identical recipe and STEP COUNT at an
    # affordable N=2048; (b) ENGINE delta — the windowed model's weights
    # evaluated under windowed AND dense (exact-KNN) engines, same
    # params. The N=10k windowed step time is recorded as the finding
    # it is: the windowed engine is an inference/oracle path, not a
    # training path.
    if not c.done("Q5_engine_delta"):
        try:
            import time as _t

            import jax.numpy as _jnp

            from deepvcp.models import DeepVCP
            from deepvcp.train import Trainer
            from deepvcp.train.trainer import make_eval_step
            from campaign_r4_common import eval_on, make_data, train_model

            NQ = 128 if TINY else 2048
            _, held_m = make_data(NQ, TINY)
            if TINY:
                cfg_q5b = dataclasses.replace(
                    DeepVCPConfig.tiny(num_points=NQ, use_normal=False),
                    neighbor_method="banded", spatial_extent=4.0,
                    band_tile=64,
                )
            else:
                cfg_q5b = DeepVCPConfig(
                    num_points=NQ, use_normal=False, spatial_extent=2.5
                )
            cfg_q5w = dataclasses.replace(
                cfg_q5b, neighbor_method="windowed", window_safety=6.0,
                knn_window=min(64 if TINY else 512, NQ),
            )
            train_q, _ = make_data(NQ, TINY)
            spe_q = len(train_q)
            sample_q = next(batch_iterator(train_q, 1, epoch=0, seed=0))
            tcfg_q = residual_tcfg()

            # probe the windowed step; size a step count both fit
            probe = Trainer(cfg_q5w, dataclasses.replace(
                tcfg_q, num_epochs=1, total_steps=spe_q,
                metrics_path=os.path.join(c.art, "q5_probe.jsonl"),
                checkpoint_dir=os.path.join(c.art, "q5_probe_ck")))
            probe.setup(sample_q)
            sq, tq, Rq, ttq = (_jnp.asarray(a) for a in sample_q)
            stp, m = probe._train_step(probe.state, sq, tq, Rq, ttq)
            float(m["loss"])
            t0 = _t.time()
            for _ in range(5):
                stp, m = probe._train_step(stp, sq, tq, Rq, ttq)
            float(m["loss"])
            win_ms = (_t.time() - t0) / 5 * 1e3
            del stp, probe
            budget_steps = int(BUDGET_Q5 * 60e3 / max(win_ms, 1e-3))
            epochs_q = max(min(budget_steps, 4 * spe_q) // spe_q, 1)
            res = {
                "windowed_step_ms_N2048": round(win_ms, 1),
                "windowed_step_ms_N10k_measured": None if TINY else 14000.0,
                "steps_each": epochs_q * spe_q,
            }
            if epochs_q * spe_q * win_ms > 2.2 * BUDGET_Q5 * 60e3:
                # even one epoch blows the budget — record the step-time
                # finding and stop; don't eat the round
                res["skipped"] = "windowed step too slow to train even " \
                                 "one epoch within ~2x budget"
                c.save("Q5_engine_delta", res)
            else:
                tr_w, rw = train_model(c, "model_q5w", cfg_q5w, tcfg_q,
                                       epochs_q, train_q, held_m,
                                       sample_q, spe_q)
                res["windowed_trained"] = rw
                tr_b, rb = train_model(c, "model_q5b", cfg_q5b, tcfg_q,
                                       epochs_q, train_q, held_m,
                                       sample_q, spe_q)
                res["banded_trained"] = rb
                del tr_b

                # engine delta: same windowed-trained weights, dense
                # (exact-KNN) engine
                for name, cfg_e in (("dense", dataclasses.replace(
                        cfg_q5w, neighbor_method="dense")),):
                    eval_e = make_eval_step(DeepVCP(cfg=cfg_e), tcfg_q)
                    res[f"windowed_weights_under_{name}"] = {
                        "uniform_small": eval_on(
                            eval_e, tr_w.state, held_m["uniform_small"],
                            batches=8),
                    }
                c.save("Q5_engine_delta", res)
                del tr_w
        except Exception:
            c.save("Q5_engine_delta", {"error": traceback.format_exc()})

    # ---- Q7: roofline at B=1 and B=8 ----------------------------------------
    if not c.done("Q7_roofline"):
        try:
            import contextlib
            import io

            from deepvcp import profile_stages

            res = {}
            for b in ((1,) if TINY else (1, 8)):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    profile_stages.main(
                        ["--num-points", str(N), "--batch", str(b)]
                        + (["--tiny", "--cpu"] if TINY else [])
                    )
                text = buf.getvalue()
                with open(os.path.join(c.art, f"roofline_B{b}.txt"),
                          "w") as fh:
                    fh.write(text)
                res[f"B{b}"] = json.loads(text.strip().splitlines()[-1])
                print(text, flush=True)
            # name the stage whose per-pair cost grows most with batch
            if "B8" in res:
                s1 = res["B1"]["stages_ms"]
                s8 = res["B8"]["stages_ms"]
                growth = {
                    k: round(s8[k] / 8.0 / max(s1[k], 1e-6), 2)
                    for k in s1 if k in s8 and s1[k] > 0.05
                }
                res["per_pair_growth_x"] = growth
                res["worst_scaling_stage"] = max(growth, key=growth.get)
            c.save("Q7_roofline", res)
        except Exception:
            c.save("Q7_roofline", {"error": traceback.format_exc()})

    print("[campaign_r4b] DONE", flush=True)


if __name__ == "__main__":
    main()
