"""Round-5 campaign part E: is the GUARD the rotation limiter?

Parts A/C measured the KITTI-scale rotation wall: every guarded
composition lands at 0.27-0.7 deg, refinement beyond 2 iters WORSENS
rotation (the trimmed-NN guard is rotation-blind at 25 m scale: 0.4 deg
displaces points ~0.17 m, under the cloud's NN spacing, so it accepts
score-better/rotation-worse poses), and more/finer everything loses.

The last eval-time lever: guard=False. The guard exists to make
refinement non-worsening for out-of-distribution inits; K1 is
residual-trained (6 deg / 0.5 m ball), so identity-init small-motion
pairs ARE in distribution and each pass should be a contraction WITHOUT
arbitration. If the wall is the guard's acceptance noise, unguarded
iteration should go below 0.27 deg; if the wall is the model, it won't.

E5 sweeps K1 guard-off at iters 2-4, the guarded baseline re-run for
same-session comparability, and the best -> k5 fine hand-off guard-off.

Artifacts: artifacts/campaign_r5e/. Restart-safe.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from campaign_r4_common import Campaign, ROOT, wait_for_device  # noqa: E402
from campaign_r5 import eval_reg  # noqa: E402


def main():
    import jax

    TINY = os.environ.get("CAMPAIGN_TINY") == "1"
    if TINY:
        jax.config.update("jax_platforms", "cpu")

    from deepvcp import DeepVCPConfig, pretrained
    from deepvcp.data import LidarLikeDataset
    from deepvcp.registration import CascadeRegistrar, Registrar

    wait_for_device()
    c = Campaign("campaign_r5e")

    if TINY:
        N, MAX_RANGE, EXTENT, n_held = 128, 2.0, 5.0, 2
        ITERS = (2,)
    else:
        N, MAX_RANGE, EXTENT, n_held = 10000, 25.0, 55.0, 16
        ITERS = (2, 3, 4)

    held = LidarLikeDataset(
        num_clouds=n_held, num_points=N, max_range=MAX_RANGE, seed=110,
        max_rotation_deg=5.0, max_translation=0.5)

    if TINY:
        cfg_coarse = dataclasses.replace(
            DeepVCPConfig.tiny(num_points=N, use_normal=False),
            neighbor_method="banded", spatial_extent=EXTENT, band_tile=64,
            tgt_knn="flat")
        cfg_fine = cfg_coarse
        from deepvcp.data import batch_iterator
        from deepvcp.models import DeepVCP
        import jax.numpy as jnp

        s, t, R, tt = next(batch_iterator(held, 1, 0, 0))
        model = DeepVCP(cfg=cfg_coarse)
        v_k1 = model.init(jax.random.key(0), jnp.asarray(s),
                          jnp.asarray(t), jnp.asarray(R), jnp.asarray(tt),
                          train=False)
        v_k5 = v_k1
    else:
        cfg_coarse = DeepVCPConfig(
            num_points=N, use_normal=False, spatial_extent=EXTENT,
            tgt_knn="flat")
        cfg_fine = dataclasses.replace(
            cfg_coarse, search_radius=0.6, voxel_len=0.2)
        v_k1 = pretrained.load_variables(
            os.path.join(ROOT, "artifacts/campaign_r4b/model_k1/final"))
        v_k5 = pretrained.load_variables(
            os.path.join(ROOT, "artifacts/campaign_r5/model_k5/final"))

    def reg(cfg, v, iters, guard):
        return Registrar(cfg, v, use_saliency_weights=True,
                         refine_iters=iters, guard=guard)

    if not c.done("E5_guard_ablation"):
        try:
            res = {}
            for it in ITERS:
                res[f"k1_it{it}_noguard"] = eval_reg(
                    reg(cfg_coarse, v_k1, it, False), held)
            # guarded baseline, same session (variance control)
            res["k1_it2_guard"] = eval_reg(
                reg(cfg_coarse, v_k1, 2, True), held)
            pool = {k: v for k, v in res.items() if "gt_free_rre_deg" in v}
            res["best"] = min(pool,
                              key=lambda k: pool[k]["gt_free_rre_deg"])
            c.save("E5_guard_ablation", res)
        except Exception:
            c.save("E5_guard_ablation", {"error": traceback.format_exc()})

    if not c.done("E6_noguard_cascade") and not TINY:
        try:
            e5 = c.summary.get("E5_guard_ablation", {})
            best = e5.get("best", "k1_it2_noguard")
            it = int(best.split("_it")[1].split("_")[0])
            guard = "noguard" not in best
            res = {"coarse": best}
            casc = CascadeRegistrar([
                reg(cfg_coarse, v_k1, it, guard),
                reg(cfg_fine, v_k5, 1, False),
            ])
            res["coarse_k5_noguard"] = eval_reg(casc, held)
            bar = {"rre_deg": 0.164, "rte_m": 0.071}
            pool = {k: v for k, v in {**e5, **res}.items()
                    if isinstance(v, dict) and "gt_free_rre_deg" in v}
            res["beats_paper_both"] = any(
                v["gt_free_rre_deg"] <= bar["rre_deg"]
                and v["gt_free_rte"] <= bar["rte_m"]
                for v in pool.values())
            res["paper_bar"] = {**bar, "caveat": "synthetic proxy"}
            c.save("E6_noguard_cascade", res)
        except Exception:
            c.save("E6_noguard_cascade", {"error": traceback.format_exc()})

    print("[campaign_r5e] DONE", flush=True)


if __name__ == "__main__":
    main()
