"""Round-3 accuracy + measurement campaign (runs on the accelerator).

One session that:

  P1  times the full train step with the Pallas banded backward vs the
      XLA static-band backward (round-2's kernel, never measured);
  P2  re-measures inference throughput and attributes the round-2 bench
      regression (bf16 vs f32 candidate-KNN selection);
  P3  measures batch scaling (B=1/2/4/8 stream throughput);
  P4  trains model A (banded engine) at the full operating point
      (N=10k, mixed uniform + lidar-like clouds) with per-epoch eval
      (warm-started AND GT-free), checkpoints, metrics JSONL;
  P5  trains model B (windowed engine, shares SetAbstraction params with
      the dense engine) and evaluates it under BOTH engines — the
      trained-model engine-accuracy delta;
  P6  odometry warm-start demo with trained model A: accelerating
      synthetic sequence where absolute motion exceeds candidate-grid
      reach but frame-to-frame acceleration does not — constant-velocity
      warm start vs identity init.

Artifacts land in artifacts/campaign_r3/ (summary.json, metrics JSONLs,
checkpoints). Every phase appends to summary.json as it completes so a
crash preserves prior phases.
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
ART = os.path.join(ROOT, "artifacts", "campaign_r3")
os.makedirs(ART, exist_ok=True)

SUMMARY_PATH = os.path.join(ART, "summary.json")
SUMMARY: dict = {}


def save(phase: str, payload):
    SUMMARY[phase] = payload
    with open(SUMMARY_PATH, "w") as fh:
        json.dump(SUMMARY, fh, indent=2, default=float)
    print(f"[campaign] {phase}: {json.dumps(payload, default=float)[:400]}",
          flush=True)


def main():
    import jax

    # CAMPAIGN_TINY=1: CPU smoke mode (tiny N, 1-2 epochs) to validate the
    # script logic without the accelerator.
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

    print(f"devices: {jax.devices()}", flush=True)


    if TINY:
        N = 128
        cfg_banded = dataclasses.replace(
            DeepVCPConfig.tiny(num_points=N, use_normal=False),
            neighbor_method="banded", spatial_extent=20.0, band_tile=64,
        )
        N_CLOUDS, N_LIDAR, EPOCHS_A, EPOCHS_B = 4, 2, 1, 1
        HELD = 2
    else:
        N = 10000
        cfg_banded = DeepVCPConfig(num_points=N, use_normal=False)
        N_CLOUDS, N_LIDAR, EPOCHS_A, EPOCHS_B = 288, 96, 26, 12
        HELD = 16

    # ---- shared data -----------------------------------------------------
    class MixedDataset:
        """Uniform + lidar-like clouds, one sample() interface."""

        def __init__(self, uniform, lidar):
            self.parts = (uniform, lidar)

        def __len__(self):
            return sum(len(p) for p in self.parts)

        def sample(self, index, rng):
            a = self.parts[0]
            if index < len(a):
                return a.sample(index, rng)
            return self.parts[1].sample(index - len(a), rng)

    train_ds = MixedDataset(
        SyntheticDataset(num_clouds=N_CLOUDS, num_points=N, extent=10.0, seed=0),
        LidarLikeDataset(num_clouds=N_LIDAR, num_points=N, max_range=10.0, seed=1),
    )
    # held-out clouds (disjoint seeds), small-motion pairs for GT-free eval
    held_uniform = SyntheticDataset(
        num_clouds=HELD, num_points=N, extent=10.0, seed=100,
        max_rotation_deg=5.0, max_translation=0.8,
    )
    held_lidar = LidarLikeDataset(
        num_clouds=HELD, num_points=N, max_range=10.0, seed=101,
        max_rotation_deg=5.0, max_translation=0.8,
    )
    held_fullso3 = SyntheticDataset(
        num_clouds=HELD, num_points=N, extent=10.0, seed=102,
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

    # ---- P4 setup first (we reuse its compiled train step for P1) --------
    tcfg_a = TrainConfig(
        num_epochs=EPOCHS_A,
        batch_size=1,
        learning_rate=1e-3,
        checkpoint_dir=os.path.join(ART, "model_a"),
        checkpoint_every_epochs=5,
        metrics_path=os.path.join(ART, "model_a_metrics.jsonl"),
        log_every=50,
    )
    trainer_a = Trainer(cfg_banded, tcfg_a)
    sample = next(batch_iterator(train_ds, 1, epoch=0, seed=0))
    t0 = time.time()
    trainer_a.setup(sample)
    print(f"trainer A setup (init): {time.time() - t0:.1f}s", flush=True)

    # random-init eval FIRST: P1's timing loop advances the train state by
    # ~21 real steps, which would contaminate the "before" baseline
    try:
        eval_step_a = trainer_a._eval_step
        before = {
            "uniform_small": eval_on(eval_step_a, trainer_a.state, held_uniform),
            "lidar_small": eval_on(eval_step_a, trainer_a.state, held_lidar),
            "full_so3": eval_on(eval_step_a, trainer_a.state, held_fullso3),
        }
        save("P4_model_a_random_init_eval", before)
    except Exception:
        save("P4_model_a_random_init_eval", {"error": traceback.format_exc()})

    # ---- P1: train-step timing (the kernel-vs-XLA-band A/B is
    # scripts/band_max_ab.py) ---------------------------------------------
    try:
        src, tgt, R, t = (jnp.asarray(a) for a in sample)

        def time_steps(step_fn, state, n=20):
            # donation invalidates the previous state; thread it through
            state, m = step_fn(state, src, tgt, R, t)  # compile
            float(m["loss"])
            t0 = time.time()
            for _ in range(n):
                state, m = step_fn(state, src, tgt, R, t)
            float(m["loss"])  # one sync
            return (time.time() - t0) / n * 1e3, state

        ms_step, trainer_a.state = time_steps(
            trainer_a._train_step, trainer_a.state
        )
        save("P1_train_step_ms", {
            "fwd_bwd_ms": round(ms_step, 2),
            "note": "B=1 N=10k full train step (fwd+bwd+Adam), steady state,"
                    " 20-step stream with one end sync",
        })
    except Exception:
        save("P1_train_step_ms", {"error": traceback.format_exc()})

    # ---- P2: inference throughput + regression attribution ---------------
    try:
        res = {}
        for name, cfg_v in [
            ("bf16_select", cfg_banded),
            ("f32_select",
             dataclasses.replace(cfg_banded, knn_select_dtype=None)),
        ]:
            model_v = DeepVCP(cfg=cfg_v)
            variables = {
                "params": trainer_a.state.params,
                "batch_stats": trainer_a.state.batch_stats,
            }
            reg = Registrar(cfg_v, variables)
            s0, t0_, _, _ = next(batch_iterator(held_fullso3, 1, seed=5))
            s0, t0_ = jnp.asarray(s0), jnp.asarray(t0_)
            np.asarray(reg(s0, t0_).R)  # compile
            runs = []
            for _ in range(3):
                tic = time.time()
                out = None
                for _ in range(30):
                    out = reg(s0, t0_)
                np.asarray(out.R)
                runs.append(30 / (time.time() - tic))
            res[name] = {
                "pairs_per_sec_runs": [round(r, 1) for r in runs],
                "best": round(max(runs), 1),
            }
        save("P2_inference_attribution", res)
    except Exception:
        save("P2_inference_attribution", {"error": traceback.format_exc()})

    # ---- P3: batch scaling ------------------------------------------------
    try:
        res = {}
        for B in (1, 2, 4, 8):
            model_v = DeepVCP(cfg=cfg_banded)
            variables = {
                "params": trainer_a.state.params,
                "batch_stats": trainer_a.state.batch_stats,
            }
            reg = Registrar(cfg_banded, variables)
            ds_b = SyntheticDataset(
                num_clouds=B, num_points=N, extent=10.0, seed=7
            )
            sb, tb, _, _ = next(batch_iterator(ds_b, B, seed=7))
            sb, tb = jnp.asarray(sb), jnp.asarray(tb)
            np.asarray(reg(sb, tb).R)
            runs = []
            for _ in range(3):
                tic = time.time()
                out = None
                for _ in range(20):
                    out = reg(sb, tb)
                np.asarray(out.R)
                runs.append(20 * B / (time.time() - tic))
            res[f"B{B}"] = round(max(runs), 1)
        save("P3_batch_scaling_pairs_per_sec", res)
    except Exception:
        save("P3_batch_scaling_pairs_per_sec", {"error": traceback.format_exc()})

    # ---- P4: accuracy campaign, model A (banded) ---------------------------
    try:
        t0 = time.time()
        trainer_a.fit(
            lambda epoch: batch_iterator(train_ds, 1, epoch=epoch, seed=0),
            lambda epoch: batch_iterator(
                held_uniform, 2, epoch=0, seed=777, shuffle=False
            ),
        )
        train_minutes = (time.time() - t0) / 60
        after = {
            "uniform_small": eval_on(eval_step_a, trainer_a.state, held_uniform),
            "lidar_small": eval_on(eval_step_a, trainer_a.state, held_lidar),
            "full_so3": eval_on(eval_step_a, trainer_a.state, held_fullso3),
            "train_minutes": round(train_minutes, 1),
            "steps": int(trainer_a.state.step),
        }
        save("P4_model_a_trained_eval", after)
    except Exception:
        save("P4_model_a_trained_eval", {"error": traceback.format_exc()})

    # ---- P5: model B (windowed) + engine comparison ------------------------
    try:
        cfg_win = dataclasses.replace(
            cfg_banded, neighbor_method="windowed", window_safety=6.0
        )
        tcfg_b = dataclasses.replace(
            tcfg_a,
            num_epochs=EPOCHS_B,
            checkpoint_dir=os.path.join(ART, "model_b"),
            metrics_path=os.path.join(ART, "model_b_metrics.jsonl"),
        )
        trainer_b = Trainer(cfg_win, tcfg_b)
        trainer_b.setup(sample)
        t0 = time.time()
        trainer_b.fit(
            lambda epoch: batch_iterator(train_ds, 1, epoch=epoch, seed=0),
        )
        bt = (time.time() - t0) / 60

        res = {"train_minutes": round(bt, 1), "steps": int(trainer_b.state.step)}
        for engine in ("windowed", "dense"):
            cfg_e = dataclasses.replace(cfg_win, neighbor_method=engine)
            eval_e = make_eval_step(DeepVCP(cfg=cfg_e), tcfg_b)
            res[engine] = {
                "uniform_small": eval_on(eval_e, trainer_b.state, held_uniform,
                                         batches=4),
                "lidar_small": eval_on(eval_e, trainer_b.state, held_lidar,
                                       batches=4),
            }
        save("P5_model_b_engine_comparison", res)
    except Exception:
        save("P5_model_b_engine_comparison", {"error": traceback.format_exc()})

    # ---- P6: odometry warm-start demo with trained model A -----------------
    try:
        from deepvcp.data.datasets import lidar_like_cloud
        from deepvcp.odometry.pipeline import register_sequence
        from deepvcp.utils.rotations import axis_angle_to_matrix

        rng = np.random.default_rng(11)
        cloud = lidar_like_cloud(rng, N, max_range=10.0).astype(np.float32)
        # accelerating trajectory: |t| grows 0.5 -> 1.9 (> grid reach 1.2),
        # acceleration 0.2/frame; yaw ~1.5 deg/frame
        F = 9
        R_abs = [np.eye(3, dtype=np.float32)]
        t_abs = [np.zeros(3, dtype=np.float32)]
        R_rel_true, t_rel_true = [], []
        for i in range(F - 1):
            Rr = axis_angle_to_matrix(
                np.array([0.0, 0.0, 1.0]), np.radians(1.5)
            ).astype(np.float32)
            tr = np.array([0.5 + 0.2 * i, 0.0, 0.0], np.float32)
            R_rel_true.append(Rr)
            t_rel_true.append(tr)
            R_abs.append(Rr @ R_abs[-1])
            t_abs.append(Rr @ t_abs[-1] + tr)
        scans = np.stack(
            [cloud @ R.T + t for R, t in zip(R_abs, t_abs)]
        ).astype(np.float32)

        variables = {
            "params": trainer_a.state.params,
            "batch_stats": trainer_a.state.batch_stats,
        }
        reg = Registrar(cfg_banded, variables)
        out = {}
        for mode, warm in (("warm_start", True), ("identity_init", False)):
            R_est, t_est = register_sequence(reg, scans, warm_start=warm)
            terr = np.linalg.norm(t_est - np.stack(t_rel_true), axis=-1)
            out[mode] = {
                "per_frame_t_err": [round(float(x), 3) for x in terr],
                "mean_t_err": round(float(terr.mean()), 3),
                "max_t_err": round(float(terr.max()), 3),
            }
        save("P6_odometry_warm_start", out)
    except Exception:
        save("P6_odometry_warm_start", {"error": traceback.format_exc()})

    print("[campaign] DONE", flush=True)


if __name__ == "__main__":
    main()
