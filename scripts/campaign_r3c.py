"""Round-3 campaign, part 3: the accuracy story on the FIXED architecture.

Campaign 2 (scripts/campaign_r3b.py) trained at ModelNet scale and hit a
plateau: GT-free RRE ~15deg / RTE ~0.42 on <=10deg held-out pairs — worse
than identity for rotation. The diagnosis (commit "fix three inherited
accuracy defects") found three structural defects inherited from the
reference (D12 grid bias -s/2, D13 asymmetric Siamese neighborhoods, D14
rotation-variant descriptor matching) plus the missing inference-side
iterative refinement. This run re-trains on the fixed defaults and
quantifies each claim:

  Q1  step-time probe at the fixed operating point (D13 cloud-mode source
      DFE adds a KNN) -> epoch budget;
  Q2  model A3 — fixed defaults, paper recipe (direct VCP term, cosine lr,
      saliency-weighted solve); eval suite before/after;
  Q3  model A3c — ABLATION: identical recipe/budget with the three fixes
      reverted to reference semantics (centered_grid=False,
      dfe_src_neighbors="keypoints", derotate_tgt_neighborhoods=False) =
      the D12-D14 accuracy delta, trained;
  Q4  Registrar refinement sweep on A3: GT-free RRE/RTE at refine_iters
      1/2/3 on small-motion AND full-SO(3) held pairs (basin extension);
  Q5  model B3 — windowed engine, shorter budget; trained weights evaluated
      under windowed AND dense engines = trained-model engine delta;
  Q6  odometry warm-start demo with A3 (accelerating sequence, motion
      beyond candidate-grid reach);
  Q7  per-stage roofline (profile_stages) at B=1 and B=8 = the
      batch-scaling attribution.

Artifacts: artifacts/campaign_r3c/ (summary.json updated per phase;
checkpoints under model_*/).

STATUS (round 4): the round-3 run was cut off during Q5 (model B3 died
in epoch 0), so this summary.json holds Q1-Q4 only. Q5 (trained-model
engine delta) and Q7 (B=1/B=8 roofline) were completed by
scripts/campaign_r4b.py (artifacts/campaign_r4b/), and Q6 grew into the
trained-model odometry + pose-graph ATE demo there (phase K2).

STATUS NOTE (round 4): the round-3 run was cut off during Q5 (model_b3
died in epoch 0), so artifacts/campaign_r3c/summary.json contains only
Q1-Q4. Q5 (trained engine delta), Q6 (odometry) and Q7 (roofline) are
re-run — on the residual-trained round-4 models, which supersede A3 —
by scripts/campaign_r4.py; see artifacts/campaign_r4/summary.json.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
ART = os.path.join(ROOT, "artifacts", "campaign_r3c")
os.makedirs(ART, exist_ok=True)

SUMMARY_PATH = os.path.join(ART, "summary.json")
SUMMARY: dict = {}


def save(phase: str, payload):
    SUMMARY[phase] = payload
    with open(SUMMARY_PATH, "w") as fh:
        json.dump(SUMMARY, fh, indent=2, default=float)
    print(f"[campaign3] {phase}: {json.dumps(payload, default=float)[:500]}",
          flush=True)


def main():
    import jax

    TINY = os.environ.get("CAMPAIGN_TINY") == "1"
    if TINY:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from deepvcp import DeepVCPConfig
    from deepvcp.config import TrainConfig
    from deepvcp.data import (
        LidarLikeDataset,
        SyntheticDataset,
        batch_iterator,
    )
    from deepvcp.models import DeepVCP
    from deepvcp.registration import Registrar
    from deepvcp.train import Trainer
    from deepvcp.train.trainer import make_eval_step
    from deepvcp.utils.rotations import rotation_geodesic_deg

    print(f"devices: {jax.devices()}", flush=True)
    t0 = time.time()
    while True:
        try:
            np.asarray(jax.jit(lambda x: x + 1)(jnp.zeros(2)))
            break
        except Exception as e:
            if time.time() - t0 > 3600:
                raise
            print(f"probe failed ({type(e).__name__}); retrying", flush=True)
            time.sleep(60)
    print(f"device responsive after {time.time() - t0:.0f}s", flush=True)

    # ---- ModelNet-scale operating point (same data as campaign 2) ----------
    if TINY:
        N, N_CLOUDS, N_LIDAR, HELD = 128, 4, 2, 2
        cfg_fixed = dataclasses.replace(
            DeepVCPConfig.tiny(num_points=N, use_normal=False),
            neighbor_method="banded", spatial_extent=4.0, band_tile=64,
        )
        BUDGET_MIN_A, BUDGET_MIN_B = 0.2, 0.2
    else:
        N, N_CLOUDS, N_LIDAR, HELD = 10000, 288, 96, 16
        cfg_fixed = DeepVCPConfig(
            num_points=N, use_normal=False, spatial_extent=2.5
        )
        BUDGET_MIN_A, BUDGET_MIN_B = 18.0, 9.0

    # the ablation: exact reference grid/DFE/matching semantics
    cfg_ref_sem = dataclasses.replace(
        cfg_fixed,
        centered_grid=False,
        dfe_src_neighbors="keypoints",
        derotate_tgt_neighborhoods=False,
    )

    EXT = 1.0          # uniform clouds span 2 (ModelNet normalization)
    LIDAR_RANGE = 1.0  # lidar-like clouds scaled to the same span

    train_parts = (
        SyntheticDataset(num_clouds=N_CLOUDS, num_points=N, extent=EXT,
                         seed=0),
        LidarLikeDataset(num_clouds=N_LIDAR, num_points=N,
                         max_range=LIDAR_RANGE, seed=1),
    )

    class MixedDataset:
        def __init__(self, parts):
            self.parts = parts

        def __len__(self):
            return sum(len(p) for p in self.parts)

        def sample(self, index, rng):
            a = self.parts[0]
            if index < len(a):
                return a.sample(index, rng)
            return self.parts[1].sample(index - len(a), rng)

    train_ds = MixedDataset(train_parts)
    held_uniform = SyntheticDataset(
        num_clouds=HELD, num_points=N, extent=EXT, seed=100,
        max_rotation_deg=10.0, max_translation=0.5,
    )
    held_lidar = LidarLikeDataset(
        num_clouds=HELD, num_points=N, max_range=LIDAR_RANGE, seed=101,
        max_rotation_deg=10.0, max_translation=0.5,
    )
    held_fullso3 = SyntheticDataset(
        num_clouds=HELD, num_points=N, extent=EXT, seed=102,
    )

    def eval_on(eval_step, state, dataset, batches=8):
        agg, n = {}, 0
        for src, tgt, R, t in batch_iterator(
            dataset, 2, epoch=0, seed=777, shuffle=False
        ):
            m, _ = eval_step(
                state, jnp.asarray(src), jnp.asarray(tgt),
                jnp.asarray(R), jnp.asarray(t),
            )
            for k, v in m.items():
                agg[k] = agg.get(k, 0.0) + float(v)
            n += 1
            if n >= batches:
                break
        return {k: round(v / n, 4) for k, v in agg.items()}

    def eval_suite(eval_step, state, batches=8):
        return {
            "uniform_small": eval_on(eval_step, state, held_uniform, batches),
            "lidar_small": eval_on(eval_step, state, held_lidar, batches),
            "full_so3": eval_on(eval_step, state, held_fullso3, batches),
        }

    steps_per_epoch = len(train_ds)

    # ---- Q1: probe step time, size the budget ------------------------------
    tcfg_probe = TrainConfig(num_epochs=1, batch_size=1,
                             metrics_path=os.path.join(ART, "probe.jsonl"),
                             checkpoint_dir=os.path.join(ART, "probe_ck"))
    probe = Trainer(cfg_fixed, tcfg_probe)
    sample = next(batch_iterator(train_ds, 1, epoch=0, seed=0))
    t0 = time.time()
    probe.setup(sample)
    print(f"probe setup: {time.time() - t0:.1f}s", flush=True)
    src, tgt, R, t = (jnp.asarray(a) for a in sample)
    st = probe.state
    st, m = probe._train_step(st, src, tgt, R, t)
    float(m["loss"])
    t0 = time.time()
    for _ in range(10):
        st, m = probe._train_step(st, src, tgt, R, t)
    float(m["loss"])
    step_ms = (time.time() - t0) / 10 * 1e3
    del st, probe

    def epochs_for(budget_min):
        steps = max(int(budget_min * 60e3 / step_ms), steps_per_epoch)
        return max(min(steps // steps_per_epoch, 40), 1)

    EPOCHS_A = epochs_for(BUDGET_MIN_A)
    EPOCHS_B = epochs_for(BUDGET_MIN_B)
    save("Q1_step_probe", {
        "fixed_arch_step_ms": round(step_ms, 2),
        "epochs_a": EPOCHS_A, "epochs_b": EPOCHS_B,
        "steps_per_epoch": steps_per_epoch,
    })

    tcfg_paper = TrainConfig(
        batch_size=1, learning_rate=1e-3, vcp_loss_weight=1.0,
        lr_schedule="cosine", warmup_steps=100,
        use_saliency_weights=True,
    )

    # ---- Q2 / Q3: fixed architecture vs reference-semantics ablation -------
    def train_model(tag, cfg_model, tcfg, epochs):
        tcfg = dataclasses.replace(
            tcfg,
            num_epochs=epochs,
            total_steps=(epochs * steps_per_epoch
                         if tcfg.lr_schedule == "cosine" else 0),
            checkpoint_dir=os.path.join(ART, tag),
            checkpoint_every_epochs=max(epochs // 2, 1),
            metrics_path=os.path.join(ART, f"{tag}_metrics.jsonl"),
            log_every=50,
        )
        tr = Trainer(cfg_model, tcfg)
        tr.setup(sample)
        before = eval_suite(tr._eval_step, tr.state, batches=4)
        t0 = time.time()
        tr.fit(
            lambda epoch: batch_iterator(train_ds, 1, epoch=epoch, seed=0),
            lambda epoch: batch_iterator(held_uniform, 2, epoch=0, seed=777,
                                         shuffle=False),
        )
        minutes = (time.time() - t0) / 60
        after = eval_suite(tr._eval_step, tr.state)
        return tr, {
            "random_init": before,
            "trained": after,
            "train_minutes": round(minutes, 1),
            "steps": int(tr.state.step),
        }

    trainer_a3 = None
    try:
        trainer_a3, res = train_model("model_a3", cfg_fixed, tcfg_paper,
                                      EPOCHS_A)
        save("Q2_model_a3_fixed_arch", res)
    except Exception:
        save("Q2_model_a3_fixed_arch", {"error": traceback.format_exc()})

    # ---- Q4: Registrar refinement sweep on A3 (GT-free, identity init) -----
    def registrar_eval(variables, cfg_model, dataset, iters, batches=8):
        reg = Registrar(cfg_model, variables, use_saliency_weights=True,
                        refine_iters=iters)
        rre = rte = n = 0.0
        for srcb, tgtb, Rb, tb in batch_iterator(
            dataset, 2, epoch=0, seed=777, shuffle=False
        ):
            out = reg(jnp.asarray(srcb), jnp.asarray(tgtb))
            rre += float(jnp.mean(
                rotation_geodesic_deg(out.R, jnp.asarray(Rb))
            ))
            rte += float(jnp.mean(
                jnp.linalg.norm(out.t - jnp.asarray(tb), axis=-1)
            ))
            n += 1
            if n >= batches:
                break
        return {"gt_free_rre_deg": round(rre / n, 4),
                "gt_free_rte": round(rte / n, 4)}

    try:
        variables_a3 = {
            "params": trainer_a3.state.params,
            "batch_stats": trainer_a3.state.batch_stats,
        }
        sweep = {}
        for iters in (1, 2, 3):
            sweep[f"iters_{iters}"] = {
                "uniform_small": registrar_eval(
                    variables_a3, cfg_fixed, held_uniform, iters, batches=4),
                "full_so3": registrar_eval(
                    variables_a3, cfg_fixed, held_fullso3, iters, batches=4),
            }
        save("Q4_registrar_refinement_sweep", sweep)
    except Exception:
        save("Q4_registrar_refinement_sweep",
             {"error": traceback.format_exc()})

    try:
        _, res = train_model("model_a3c", cfg_ref_sem, tcfg_paper, EPOCHS_A)
        save("Q3_model_a3c_reference_semantics_ablation", res)
    except Exception:
        save("Q3_model_a3c_reference_semantics_ablation",
             {"error": traceback.format_exc()})

    # ---- Q5: windowed engine + trained-model engine comparison -------------
    try:
        cfg_win = dataclasses.replace(
            cfg_fixed, neighbor_method="windowed", window_safety=6.0,
            knn_window=min(4096, N),
        )
        trainer_b3, res = train_model("model_b3", cfg_win, tcfg_paper,
                                      EPOCHS_B)
        for engine in ("dense",):
            cfg_e = dataclasses.replace(cfg_win, neighbor_method=engine)
            eval_e = make_eval_step(DeepVCP(cfg=cfg_e), tcfg_paper)
            res[f"trained_{engine}_engine"] = {
                "uniform_small": eval_on(eval_e, trainer_b3.state,
                                         held_uniform, batches=4),
            }
        save("Q5_model_b3_windowed_engine_delta", res)
        del trainer_b3
    except Exception:
        save("Q5_model_b3_windowed_engine_delta",
             {"error": traceback.format_exc()})

    # ---- Q6: odometry warm-start demo with A3 ------------------------------
    try:
        from deepvcp.data.datasets import lidar_like_cloud
        from deepvcp.odometry.pipeline import register_sequence
        from deepvcp.utils.rotations import axis_angle_to_matrix

        rng = np.random.default_rng(11)
        cloud = lidar_like_cloud(rng, N, max_range=LIDAR_RANGE).astype(
            np.float32
        )
        # accelerating: |t| grows 0.3 -> 1.45 (> grid reach 1.2) in 0.15
        # steps (constant-velocity prior error ~0.15, well inside reach)
        F = 10
        R_abs = [np.eye(3, dtype=np.float32)]
        t_abs = [np.zeros(3, dtype=np.float32)]
        R_rel_true, t_rel_true = [], []
        for i in range(F - 1):
            Rr = axis_angle_to_matrix(
                np.array([0.0, 0.0, 1.0]), np.radians(1.5)
            ).astype(np.float32)
            tr_ = np.array([0.3 + 0.15 * i, 0.05, 0.0], np.float32)
            R_rel_true.append(Rr)
            t_rel_true.append(tr_)
            R_abs.append(Rr @ R_abs[-1])
            t_abs.append(Rr @ t_abs[-1] + tr_)
        scans = np.stack(
            [cloud @ Rm.T + tv for Rm, tv in zip(R_abs, t_abs)]
        ).astype(np.float32)

        reg = Registrar(cfg_fixed, variables_a3, use_saliency_weights=True)
        out = {}
        for mode, warm in (("warm_start", True), ("identity_init", False)):
            R_est, t_est = register_sequence(reg, scans, warm_start=warm)
            terr = np.linalg.norm(t_est - np.stack(t_rel_true), axis=-1)
            out[mode] = {
                "per_frame_t_err": [round(float(x), 3) for x in terr],
                "mean_t_err": round(float(terr.mean()), 3),
                "max_t_err": round(float(terr.max()), 3),
            }
        save("Q6_odometry_warm_start", out)
    except Exception:
        save("Q6_odometry_warm_start", {"error": traceback.format_exc()})

    # ---- Q7: roofline + batch scaling attribution ---------------------------
    try:
        import contextlib
        import io

        from deepvcp import profile_stages

        res = {}
        for b in (1, 8) if not TINY else (1,):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                profile_stages.main(
                    ["--num-points", str(N), "--batch", str(b)]
                    + (["--tiny", "--cpu"] if TINY else [])
                )
            text = buf.getvalue()
            last = text.strip().splitlines()[-1]
            res[f"B{b}"] = json.loads(last)
            print(text, flush=True)
        save("Q7_roofline", res)
    except Exception:
        save("Q7_roofline", {"error": traceback.format_exc()})

    print("[campaign3] DONE", flush=True)


if __name__ == "__main__":
    main()
