"""Round-4 campaign, part 3: close the lidar gap.

Part 1 left lidar-like clouds ~5x worse than uniform (GT-free RRE 7.5
vs 0.8 deg with the fine stage). Two candidate levers, measured here:

  L1  train-mix rebalance: the part-1 mix is 288 uniform + 96 lidar
      (75/25); fine-tune model_fine on a lidar-heavy (25/75) mix with
      the same residual recipe -> does lidar RRE drop without giving
      back the uniform result?
  S1  (only if part 1's DECISION says salient_fps won on lidar)
      fine-grid stage on top of model_r1s: fine-tune with
      keypoint_selection="salient_fps" + the fine grid
      (search_radius=0.6, voxel_len=0.2), sweep like FINE.
  FINAL  the best lidar configuration + numbers, written for the README
      truth pass.

Artifacts: artifacts/campaign_r4c/. Restart-safe like parts 1-2.
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

    from deepvcp import DeepVCPConfig
    from deepvcp.data import (
        LidarLikeDataset,
        SyntheticDataset,
        batch_iterator,
    )

    wait_for_device()
    c = Campaign("campaign_r4c")

    art_p1 = os.path.join(os.path.dirname(c.art), "campaign_r4")
    with open(os.path.join(art_p1, "summary.json")) as fh:
        p1 = json.load(fh)

    if TINY:
        N = 128
        cfg_fixed = dataclasses.replace(
            DeepVCPConfig.tiny(num_points=N, use_normal=False),
            neighbor_method="banded", spatial_extent=4.0, band_tile=64,
        )
        cfg_fine = cfg_fixed
        BUDGET_L1 = BUDGET_S1 = 0.2
        n_uni, n_lidar, n_held = 1, 3, 2
    else:
        N = 10000
        cfg_fixed = DeepVCPConfig(
            num_points=N, use_normal=False, spatial_extent=2.5
        )
        cfg_fine = dataclasses.replace(
            cfg_fixed, search_radius=0.6, voxel_len=0.2
        )
        BUDGET_L1, BUDGET_S1 = 14.0, 14.0
        n_uni, n_lidar, n_held = 96, 288, 16

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

    # lidar-HEAVY mix (same two generators as part 1, new balance)
    train_ds = MixedDataset((
        SyntheticDataset(num_clouds=n_uni, num_points=N, extent=1.0,
                         seed=0),
        LidarLikeDataset(num_clouds=n_lidar, num_points=N, max_range=1.0,
                         seed=1),
    ))
    held = {
        "uniform_small": SyntheticDataset(
            num_clouds=n_held, num_points=N, extent=1.0, seed=100,
            max_rotation_deg=10.0, max_translation=0.5),
        "lidar_small": LidarLikeDataset(
            num_clouds=n_held, num_points=N, max_range=1.0, seed=101,
            max_rotation_deg=10.0, max_translation=0.5),
    }
    steps_per_epoch = len(train_ds)
    sample = next(batch_iterator(train_ds, 1, epoch=0, seed=0))
    tcfg_fine = dataclasses.replace(
        residual_tcfg(rot_jitter_deg=8.0, trans_jitter=0.35))

    step_ms = p1.get("P0_step_probe", {}).get("residual_step_ms", 90.0)

    def epochs_for(budget_min):
        steps = max(int(budget_min * 60e3 / step_ms), steps_per_epoch)
        return max(min(steps // steps_per_epoch, 60), 1)

    # part-1 epoch budgets, for rebuilding source trainers on restore
    def p1_epochs(budget_min, spe):
        steps = max(int(budget_min * 60e3 / step_ms), spe)
        return max(min(steps // spe, 60), 1)

    P1_SPE = p1["P0_step_probe"]["steps_per_epoch"]

    # ---- L1: lidar-heavy fine-tune of the fine-grid model -------------------
    if not c.done("L1_lidar_heavy_finetune"):
        try:
            init_l = None
            if not TINY:   # the committed ckpt is full-size; TINY smokes
                tr_fine = load_trained(
                    Campaign("campaign_r4"), "model_fine", cfg_fine,
                    tcfg_fine, p1_epochs(15.0, P1_SPE), sample, P1_SPE)
                init_l = tr_fine.state
            tr_l, res = train_model(
                c, "model_lfine", cfg_fine, tcfg_fine,
                epochs_for(BUDGET_L1), train_ds, held, sample,
                steps_per_epoch, init_state=init_l)
            if init_l is not None:
                del tr_fine, init_l
            c.save("L1_lidar_heavy_finetune", res)
            variables_l = variables_of(tr_l)
            c.save("L1_sweep", {
                f"iters_{i}": {
                    name: registrar_eval(cfg_fine, variables_l, held[name],
                                         i, batches=8)
                    for name in ("uniform_small", "lidar_small")}
                for i in (1, 2, 3)
            })
            del tr_l
        except Exception:
            c.save("L1_lidar_heavy_finetune",
                   {"error": traceback.format_exc()})

    # ---- S1: salient-fps fine stage (conditional) ----------------------------
    sfps_won = bool(p1.get("DECISION", {}).get("salient_fps_wins_lidar"))
    if sfps_won and not c.done("S1_sfps_fine"):
        try:
            cfg_sfps = dataclasses.replace(
                cfg_fixed, keypoint_selection="salient_fps")
            cfg_sfps_fine = dataclasses.replace(
                cfg_fine, keypoint_selection="salient_fps")
            init_s = None
            if not TINY:
                tr_r1s = load_trained(
                    Campaign("campaign_r4"), "model_r1s", cfg_sfps,
                    residual_tcfg(), p1_epochs(25.0, P1_SPE), sample,
                    P1_SPE)
                init_s = tr_r1s.state
            tr_s, res = train_model(
                c, "model_sfine", cfg_sfps_fine, tcfg_fine,
                epochs_for(BUDGET_S1), train_ds, held, sample,
                steps_per_epoch, init_state=init_s)
            if init_s is not None:
                del tr_r1s, init_s
            c.save("S1_sfps_fine", res)
            variables_s = variables_of(tr_s)
            c.save("S1_sweep", {
                f"iters_{i}": {
                    name: registrar_eval(cfg_sfps_fine, variables_s,
                                         held[name], i, batches=8)
                    for name in ("uniform_small", "lidar_small")}
                for i in (1, 2, 3)
            })
            del tr_s
        except Exception:
            c.save("S1_sfps_fine", {"error": traceback.format_exc()})
    elif not sfps_won:
        c.save("S1_sfps_fine", {"skipped": "salient_fps did not win lidar "
                                           "in part 1's DECISION"})

    # ---- FINAL: best lidar configuration ------------------------------------
    try:
        def best(summary, sweep_key, set_name):
            sweep = summary.get(sweep_key, {})
            rows = [(k, v[set_name]) for k, v in sweep.items()
                    if k.startswith("iters_") and isinstance(v, dict)
                    and set_name in v]
            if not rows:
                return None
            k, r = min(rows, key=lambda kr: (kr[1]["gt_free_rre_deg"]
                                             + 10 * kr[1]["gt_free_rte"]))
            return dict(r, iters=k)

        candidates = {
            "part1_fine_topk": best(p1, "FINE_sweep", "lidar_small"),
            "lidar_heavy_finetune": best(c.summary, "L1_sweep",
                                         "lidar_small"),
            "sfps_fine": best(c.summary, "S1_sweep", "lidar_small"),
        }
        live = {k: v for k, v in candidates.items() if v is not None}
        winner = min(live, key=lambda k: (live[k]["gt_free_rre_deg"]
                                          + 10 * live[k]["gt_free_rte"]))
        c.save("FINAL_lidar", {
            "candidates": candidates,
            "winner": winner,
            "uniform_check": {
                "part1_fine_topk": best(p1, "FINE_sweep", "uniform_small"),
                "lidar_heavy_finetune": best(c.summary, "L1_sweep",
                                             "uniform_small"),
                "sfps_fine": best(c.summary, "S1_sweep", "uniform_small"),
            },
        })
    except Exception:
        c.save("FINAL_lidar", {"error": traceback.format_exc()})

    print("[campaign_r4c] DONE", flush=True)


if __name__ == "__main__":
    main()
