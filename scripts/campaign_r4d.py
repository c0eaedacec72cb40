"""Round-4 campaign, part 4: push the two headline models further.

K1 reached GT-free 0.27 deg / 0.0097 m after only 15 360 steps
(8.5 min of device time) — the paper's KITTI bar is 0.164 deg / 0.071 m
mean (BASELINE.md, real KITTI; our proxy is synthetic 25 m lidar-like
pairs, an easier problem but the same meter-scale pipeline). Training
was clearly not saturated. Two phases:

  K3  continue model_k1 for ~3x more steps (same data/recipe, fresh
      cosine cycle) -> eval + guarded sweep; `beats_paper_rre` recorded.
  F2  continue model_fine (ModelNet-scale headline, 0.80 deg/0.026 at
      3 iters) for ~2x more steps -> sweep at iters 3.

Artifacts: artifacts/campaign_r4d/. Restart-safe.
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
    c = Campaign("campaign_r4d")

    if TINY:
        N, MAX_RANGE, EXTENT = 128, 2.0, 5.0
        n_train, n_held = 4, 2
        BUDGET_K3, BUDGET_F2 = 0.2, 0.2
    else:
        N, MAX_RANGE, EXTENT = 10000, 25.0, 55.0
        n_train, n_held = 256, 16
        BUDGET_K3, BUDGET_F2 = 25.0, 14.0

    # ---- K3: extended KITTI-scale training ----------------------------------
    if TINY:
        cfg_k = dataclasses.replace(
            DeepVCPConfig.tiny(num_points=N, use_normal=False),
            neighbor_method="banded", spatial_extent=EXTENT, band_tile=64,
        )
    else:
        cfg_k = DeepVCPConfig(
            num_points=N, use_normal=False, spatial_extent=EXTENT
        )
    train_k = LidarLikeDataset(num_clouds=n_train, num_points=N,
                               max_range=MAX_RANGE, seed=10)
    held_k = {
        "lidar25_small": LidarLikeDataset(
            num_clouds=n_held, num_points=N, max_range=MAX_RANGE, seed=110,
            max_rotation_deg=5.0, max_translation=0.5),
    }
    tcfg_k = residual_tcfg(rot_jitter_deg=6.0, trans_jitter=0.5)
    spe_k = len(train_k)
    sample_k = next(batch_iterator(train_k, 1, epoch=0, seed=0))

    # K1's measured step time (33 ms at the KITTI point; see
    # campaign_r4b model_k1: 15360 steps in 8.5 min)
    step_ms = 90.0 if TINY else 33.0

    def epochs_for(budget_min, spe):
        steps = max(int(budget_min * 60e3 / step_ms), spe)
        return max(min(steps // spe, 200), 1)

    if not c.done("K3_extended"):
        try:
            init_k = None
            if not TINY:
                tr_k1 = load_trained(
                    Campaign("campaign_r4b"), "model_k1", cfg_k, tcfg_k,
                    60, sample_k, spe_k)
                init_k = tr_k1.state
            tr_k, res = train_model(
                c, "model_k3", cfg_k, tcfg_k,
                epochs_for(BUDGET_K3, spe_k), train_k, held_k, sample_k,
                spe_k, init_state=init_k)
            if init_k is not None:
                del tr_k1, init_k
            c.save("K3_extended", res)
            variables_k = variables_of(tr_k)
            sweep = {
                f"iters_{i}": {
                    "lidar25_small": registrar_eval(
                        cfg_k, variables_k, held_k["lidar25_small"], i,
                        batches=8)}
                for i in ((1,) if TINY else (1, 2))
            }
            best = min(
                (v["lidar25_small"] for v in sweep.values()),
                key=lambda r: r["gt_free_rre_deg"])
            sweep["beats_paper_rre"] = bool(
                best["gt_free_rre_deg"] <= 0.164)
            sweep["paper_bar"] = {"rre_deg": 0.164, "rte_m": 0.071,
                                  "caveat": "paper = real KITTI; this = "
                                            "synthetic lidar-like proxy"}
            c.save("K3_sweep", sweep)
            del tr_k
        except Exception:
            c.save("K3_extended", {"error": traceback.format_exc()})

    # ---- F2: extended ModelNet-scale fine model -----------------------------
    if TINY:
        cfg_f = dataclasses.replace(
            DeepVCPConfig.tiny(num_points=N, use_normal=False),
            neighbor_method="banded", spatial_extent=4.0, band_tile=64,
        )
    else:
        cfg_f = DeepVCPConfig(
            num_points=N, use_normal=False, spatial_extent=2.5,
            search_radius=0.6, voxel_len=0.2,
        )
    tcfg_f = residual_tcfg(rot_jitter_deg=8.0, trans_jitter=0.35)
    step_f = 90.0 if TINY else 83.0

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

    train_f = MixedDataset((
        SyntheticDataset(num_clouds=n_train // 4 * 3, num_points=N,
                         extent=1.0, seed=0),
        LidarLikeDataset(num_clouds=n_train // 4, num_points=N,
                         max_range=1.0, seed=1),
    ))
    held_f = {
        "uniform_small": SyntheticDataset(
            num_clouds=n_held, num_points=N, extent=1.0, seed=100,
            max_rotation_deg=10.0, max_translation=0.5),
    }
    spe_f = len(train_f)
    sample_f = next(batch_iterator(train_f, 1, epoch=0, seed=0))

    if not c.done("F2_extended"):
        try:
            init_f = None
            if not TINY:
                tr_fine = load_trained(
                    Campaign("campaign_r4"), "model_fine", cfg_f, tcfg_f,
                    28, sample_f, spe_f)
                init_f = tr_fine.state
            ep_f = max(int(BUDGET_F2 * 60e3 / step_f) // spe_f, 1)
            tr_f, res = train_model(
                c, "model_f2", cfg_f, tcfg_f, ep_f, train_f, held_f,
                sample_f, spe_f, init_state=init_f)
            if init_f is not None:
                del tr_fine, init_f
            c.save("F2_extended", res)
            variables_f = variables_of(tr_f)
            c.save("F2_sweep", {
                "iters_3": {
                    "uniform_small": registrar_eval(
                        cfg_f, variables_f, held_f["uniform_small"],
                        1 if TINY else 3, batches=8)}
            })
            del tr_f
        except Exception:
            c.save("F2_extended", {"error": traceback.format_exc()})

    print("[campaign_r4d] DONE", flush=True)


if __name__ == "__main__":
    main()
