"""Round-5 campaign part I: longer rotation-weighted schedule (K8).

Part G confirmed the rotation-objective diagnosis: 10 minutes of
rot_loss_weight=3 training moved the wall 0.27 -> 0.2365 deg (and made
iteration stable). K8 continues model_k7_w3 for a 3x longer budget
under the same recipe — measuring whether the trend continues toward
the paper bar (0.164 deg) or saturates.

Artifacts: artifacts/campaign_r5i/. Restart-safe.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from campaign_r4_common import (  # noqa: E402
    Campaign,
    ROOT,
    load_trained,
    residual_tcfg,
    train_model,
    variables_of,
    wait_for_device,
)
from campaign_r5 import eval_reg  # noqa: E402


def main():
    import jax

    TINY = os.environ.get("CAMPAIGN_TINY") == "1"
    if TINY:
        jax.config.update("jax_platforms", "cpu")

    from deepvcp import DeepVCPConfig, pretrained
    from deepvcp.data import LidarLikeDataset, batch_iterator
    from deepvcp.registration import Registrar

    wait_for_device()
    c = Campaign("campaign_r5i")

    if TINY:
        N, MAX_RANGE, EXTENT = 128, 2.0, 5.0
        n_train, n_held, BUDGET = 4, 2, 0.2
    else:
        N, MAX_RANGE, EXTENT = 10000, 25.0, 55.0
        n_train, n_held, BUDGET = 256, 16, 36.0

    train_k = LidarLikeDataset(num_clouds=n_train, num_points=N,
                               max_range=MAX_RANGE, seed=10)
    held = LidarLikeDataset(
        num_clouds=n_held, num_points=N, max_range=MAX_RANGE, seed=110,
        max_rotation_deg=5.0, max_translation=0.5)

    if TINY:
        cfg_coarse = dataclasses.replace(
            DeepVCPConfig.tiny(num_points=N, use_normal=False),
            neighbor_method="banded", spatial_extent=EXTENT, band_tile=64,
            tgt_knn="flat")
    else:
        cfg_coarse = DeepVCPConfig(
            num_points=N, use_normal=False, spatial_extent=EXTENT,
            tgt_knn="flat")

    spe = len(train_k)
    sample = next(batch_iterator(train_k, 1, epoch=0, seed=0))
    tcfg = dataclasses.replace(
        residual_tcfg(rot_jitter_deg=6.0, trans_jitter=0.5),
        rot_loss_weight=3.0)
    step_ms = 90.0 if TINY else 33.0
    epochs = max(min(int(BUDGET * 60e3 / step_ms) // spe, 400), 1)

    if not c.done("K8_long_rot"):
        try:
            init = None
            if not TINY:
                tr7 = load_trained(
                    Campaign("campaign_r5g"), "model_k7_w3", cfg_coarse,
                    tcfg, 85, sample, spe)
                init = tr7.state
            tr, res = train_model(
                c, "model_k8", cfg_coarse, tcfg, epochs, train_k,
                {"lidar25_small": held}, sample, spe, init_state=init)
            if init is not None:
                del tr7, init
            c.save("K8_long_rot", res)
            del tr
        except Exception:
            c.save("K8_long_rot", {"error": traceback.format_exc()})

    if not c.done("E9_sweep") and c.done("K8_long_rot"):
        try:
            v = pretrained.load_variables(os.path.join(
                ROOT, "artifacts/campaign_r5i/model_k8/final"))
            res = {}
            for it in ((1,) if TINY else (2, 3)):
                reg = Registrar(cfg_coarse, v, use_saliency_weights=True,
                                refine_iters=it, guard=True)
                res[f"it{it}"] = eval_reg(reg, held)
            pool = {k: val for k, val in res.items()
                    if "gt_free_rre_deg" in val}
            best = min(pool.values(), key=lambda v_: v_["gt_free_rre_deg"])
            res["beats_paper_both"] = bool(
                best["gt_free_rre_deg"] <= 0.164
                and best["gt_free_rte"] <= 0.071)
            res["baselines"] = {"kitti25": [0.2686, 0.0097],
                                "kitti25-rot (K7)": [0.2365, 0.0071]}
            c.save("E9_sweep", res)
        except Exception:
            c.save("E9_sweep", {"error": traceback.format_exc()})

    print("[campaign_r5i] DONE", flush=True)


if __name__ == "__main__":
    main()
