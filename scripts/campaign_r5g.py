"""Round-5 campaign part G: training-side rotation push (K7).

Parts C/E characterized the KITTI-scale rotation wall (0.27 deg, every
eval-time lever worse) and located the cause in the OBJECTIVE: at 25 m
range the point-space loss terms are translation-dominated, so rotation
is under-supervised and training plateaus at 0.27-0.9 deg while RTE
reaches millimeters. K7 continues the kitti25 coarse model's training
with the new explicit rotation term (loss/registration.py rot_weight:
mean ||R_solved - R_gt||_F ~ sqrt(2) * theta, gradients through the
SVD) under the same residual recipe.

  K7a  rot_weight=3   (rotation term ~ comparable to the point terms)
  K7b  rot_weight=10  (rotation-dominant)
  E7   guarded sweep of each at iters 1-3, then the best inside the
       cascade; beats-paper verdict (0.164 deg / 0.071 m).

Artifacts: artifacts/campaign_r5g/. Restart-safe.
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
    from deepvcp.registration import CascadeRegistrar, Registrar

    wait_for_device()
    c = Campaign("campaign_r5g")

    if TINY:
        N, MAX_RANGE, EXTENT = 128, 2.0, 5.0
        n_train, n_held, BUDGET = 4, 2, 0.2
        WEIGHTS = (3.0,)
    else:
        N, MAX_RANGE, EXTENT = 10000, 25.0, 55.0
        n_train, n_held, BUDGET = 256, 16, 12.0
        WEIGHTS = (3.0, 10.0)

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
        cfg_fine = cfg_ultra = cfg_coarse
    else:
        cfg_coarse = DeepVCPConfig(
            num_points=N, use_normal=False, spatial_extent=EXTENT,
            tgt_knn="flat")
        cfg_fine = dataclasses.replace(
            cfg_coarse, search_radius=0.6, voxel_len=0.2)
        cfg_ultra = dataclasses.replace(
            cfg_coarse, search_radius=0.3, voxel_len=0.1)

    spe = len(train_k)
    sample = next(batch_iterator(train_k, 1, epoch=0, seed=0))
    # K1's own recipe (6 deg / 0.5 ball) + the rotation term
    base_tcfg = residual_tcfg(rot_jitter_deg=6.0, trans_jitter=0.5)
    step_ms = 90.0 if TINY else 33.0
    epochs = max(min(int(BUDGET * 60e3 / step_ms) // spe, 200), 1)

    def k1_state():
        tr = load_trained(
            Campaign("campaign_r4b"), "model_k1", cfg_coarse, base_tcfg,
            120, sample, spe)
        return tr

    results = {}
    for w in WEIGHTS:
        tag = f"model_k7_w{int(w)}"
        phase = f"K7_w{int(w)}"
        if c.done(phase):
            continue
        try:
            tcfg = dataclasses.replace(base_tcfg, rot_loss_weight=w)
            init = None
            if not TINY:
                tr_k1 = k1_state()
                init = tr_k1.state
            tr, res = train_model(
                c, tag, cfg_coarse, tcfg, epochs, train_k,
                {"lidar25_small": held}, sample, spe, init_state=init)
            if init is not None:
                del tr_k1, init
            c.save(phase, res)
            del tr
        except Exception:
            c.save(phase, {"error": traceback.format_exc()})

    if not c.done("E7_sweep"):
        try:
            res = {}
            for w in WEIGHTS:
                tag = f"model_k7_w{int(w)}"
                path = os.path.join(ROOT, "artifacts/campaign_r5g", tag,
                                    "final")
                if not os.path.isdir(path):
                    continue
                v = pretrained.load_variables(path)
                for it in ((1,) if TINY else (1, 2, 3)):
                    reg = Registrar(cfg_coarse, v,
                                    use_saliency_weights=True,
                                    refine_iters=it, guard=True)
                    res[f"w{int(w)}_it{it}"] = eval_reg(reg, held)
            pool = {k: val for k, val in res.items()
                    if "gt_free_rre_deg" in val}
            if pool:
                res["best"] = min(
                    pool, key=lambda k: pool[k]["gt_free_rre_deg"])
            c.save("E7_sweep", res)
        except Exception:
            c.save("E7_sweep", {"error": traceback.format_exc()})

    if not c.done("E8_cascade") and not TINY:
        try:
            best = c.summary.get("E7_sweep", {}).get("best")
            if best is None:
                raise RuntimeError("no E7 results")
            w = best.split("_")[0][1:]
            it = int(best.split("_it")[1])
            v7 = pretrained.load_variables(os.path.join(
                ROOT, f"artifacts/campaign_r5g/model_k7_w{w}", "final"))
            v5 = pretrained.load_variables(os.path.join(
                ROOT, "artifacts/campaign_r5/model_k5/final"))
            v6 = pretrained.load_variables(os.path.join(
                ROOT, "artifacts/campaign_r5/model_k6/final"))

            def reg(cfg, v, iters):
                return Registrar(cfg, v, use_saliency_weights=True,
                                 refine_iters=iters, guard=True)

            res = {"coarse": best}
            casc = CascadeRegistrar([
                reg(cfg_coarse, v7, it), reg(cfg_fine, v5, 1),
                reg(cfg_ultra, v6, 2)])
            res["k7_k5_k6"] = eval_reg(casc, held)
            bar = {"rre_deg": 0.164, "rte_m": 0.071}
            pool = [v for v in (res["k7_k5_k6"],
                                c.summary["E7_sweep"].get(best))
                    if isinstance(v, dict) and "gt_free_rre_deg" in v]
            res["beats_paper_both"] = any(
                v["gt_free_rre_deg"] <= bar["rre_deg"]
                and v["gt_free_rte"] <= bar["rte_m"] for v in pool)
            res["paper_bar"] = {**bar, "caveat": "synthetic proxy"}
            c.save("E8_cascade", res)
        except Exception:
            c.save("E8_cascade", {"error": traceback.format_exc()})

    print("[campaign_r5g] DONE", flush=True)


if __name__ == "__main__":
    main()
