"""Round-5 campaign part C: the KITTI-scale ROTATION push (eval-only).

Part A measured the cascade: fine grids take RTE to 0.0027 m (26x under
the paper bar) but ROTATION never beats the coarse model's 2-iter 0.27
deg — the fine stages accept score-improving poses that wiggle rotation
(at 25 m range, 0.4 deg displaces points ~0.17 m, below the cloud's NN
spacing, so the trimmed-NN guard is rotation-blind at that precision),
and the fine models' own training floor is ~0.9 deg.

Two levers that need NO training (checkpoint params are per-point /
per-neighborhood, so num_keypoints and refine_iters are free at
inference):

  E1  deeper guarded refinement of the coarse model (iters 3-4) —
      round-4 only ever swept 1-2 (1.34 -> 0.27);
  E2  more inference keypoints: K=128/256 instead of the reference's 64
      — the weighted-SVD rotation noise scales ~1/sqrt(K * lever^2),
      so 4x the VCP constraints should cut the 0.27 deg floor toward
      the paper bar (0.164);
  E3  the winner feeding the fine stage for the RTE headline, checking
      rotation survives;
  E4  paper-bar verdict on the best (RRE, RTE) operating point.

Artifacts: artifacts/campaign_r5c/. Restart-safe.
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
    c = Campaign("campaign_r5c")

    if TINY:
        N, MAX_RANGE, EXTENT = 128, 2.0, 5.0
        n_held = 2
        K_SWEEP = (32,)
        ITER_SWEEP = (2,)
    else:
        N, MAX_RANGE, EXTENT = 10000, 25.0, 55.0
        n_held = 16
        K_SWEEP = (128, 256)
        ITER_SWEEP = (3, 4)

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
        v_k5 = v_k6 = v_k1
    else:
        cfg_coarse = DeepVCPConfig(
            num_points=N, use_normal=False, spatial_extent=EXTENT,
            tgt_knn="flat")
        cfg_fine = dataclasses.replace(
            cfg_coarse, search_radius=0.6, voxel_len=0.2)
        cfg_ultra = dataclasses.replace(
            cfg_coarse, search_radius=0.3, voxel_len=0.1)
        v_k1 = pretrained.load_variables(
            os.path.join(ROOT, "artifacts/campaign_r4b/model_k1/final"))
        v_k5 = pretrained.load_variables(
            os.path.join(ROOT, "artifacts/campaign_r5/model_k5/final"))
        v_k6 = pretrained.load_variables(
            os.path.join(ROOT, "artifacts/campaign_r5/model_k6/final"))

    def reg(cfg, v, iters):
        return Registrar(cfg, v, use_saliency_weights=True,
                         refine_iters=iters, guard=True)

    # --- E1: deeper coarse refinement ------------------------------------
    if not c.done("E1_deep_iters"):
        try:
            res = {}
            for it in ITER_SWEEP:
                res[f"k1_iters{it}"] = eval_reg(
                    reg(cfg_coarse, v_k1, it), held)
            c.save("E1_deep_iters", res)
        except Exception:
            c.save("E1_deep_iters", {"error": traceback.format_exc()})

    # --- E2: more inference keypoints ------------------------------------
    if not c.done("E2_more_keypoints"):
        try:
            res = {}
            for K in K_SWEEP:
                cfg_k = dataclasses.replace(cfg_coarse, num_keypoints=K)
                for it in ((2,) if TINY else (2, 3)):
                    res[f"k1_K{K}_iters{it}"] = eval_reg(
                        reg(cfg_k, v_k1, it), held)
            pool = {k: v for k, v in res.items() if "error" not in v}
            res["best"] = min(
                pool, key=lambda k: pool[k]["gt_free_rre_deg"])
            c.save("E2_more_keypoints", res)
        except Exception:
            c.save("E2_more_keypoints", {"error": traceback.format_exc()})

    # --- E3: best rotation config + fine stage for RTE --------------------
    if not c.done("E3_best_cascade") and not TINY:
        try:
            e1 = c.summary.get("E1_deep_iters", {})
            e2 = c.summary.get("E2_more_keypoints", {})
            pool = {}
            pool["k1_iters2_r4b"] = {"gt_free_rre_deg": 0.2686,
                                     "cfg": ("K", 64, "it", 2)}
            for k, v in e1.items():
                if isinstance(v, dict) and "gt_free_rre_deg" in v:
                    it = int(k.rsplit("iters", 1)[1])
                    pool[k] = {"gt_free_rre_deg": v["gt_free_rre_deg"],
                               "cfg": ("K", 64, "it", it)}
            for k, v in e2.items():
                if isinstance(v, dict) and "gt_free_rre_deg" in v:
                    K = int(k.split("_K")[1].split("_")[0])
                    it = int(k.rsplit("iters", 1)[1])
                    pool[k] = {"gt_free_rre_deg": v["gt_free_rre_deg"],
                               "cfg": ("K", K, "it", it)}
            best_key = min(pool, key=lambda k: pool[k]["gt_free_rre_deg"])
            _, K, _, it = pool[best_key]["cfg"]
            cfg_c = dataclasses.replace(cfg_coarse, num_keypoints=K)
            cfg_f = dataclasses.replace(cfg_fine, num_keypoints=K)
            cfg_u = dataclasses.replace(cfg_ultra, num_keypoints=K)
            res = {"chosen_coarse": best_key}
            casc2 = CascadeRegistrar(
                [reg(cfg_c, v_k1, it), reg(cfg_f, v_k5, 1)])
            res["coarse_k5"] = eval_reg(casc2, held)
            casc3 = CascadeRegistrar(
                [reg(cfg_c, v_k1, it), reg(cfg_f, v_k5, 1),
                 reg(cfg_u, v_k6, 1)])
            res["coarse_k5_k6"] = eval_reg(casc3, held)
            c.save("E3_best_cascade", res)
        except Exception:
            c.save("E3_best_cascade", {"error": traceback.format_exc()})

    # --- E4: verdict -------------------------------------------------------
    if not c.done("E4_verdict") and not TINY:
        try:
            candidates = {}
            for phase in ("E1_deep_iters", "E2_more_keypoints",
                          "E3_best_cascade"):
                for k, v in c.summary.get(phase, {}).items():
                    if isinstance(v, dict) and "gt_free_rre_deg" in v:
                        candidates[f"{phase}:{k}"] = v
            best_rre = min(candidates.items(),
                           key=lambda kv: kv[1]["gt_free_rre_deg"])
            best_rte = min(candidates.items(),
                           key=lambda kv: kv[1]["gt_free_rte"])
            bar = {"rre_deg": 0.164, "rte_m": 0.071}
            c.save("E4_verdict", {
                "best_rre": {"name": best_rre[0], **best_rre[1]},
                "best_rte": {"name": best_rte[0], **best_rte[1]},
                "beats_paper_both_one_config": any(
                    v["gt_free_rre_deg"] <= bar["rre_deg"]
                    and v["gt_free_rte"] <= bar["rte_m"]
                    for v in candidates.values()),
                "paper_bar": {**bar, "caveat": "paper = real KITTI; "
                              "this = synthetic lidar-like proxy"},
            })
        except Exception:
            c.save("E4_verdict", {"error": traceback.format_exc()})

    print("[campaign_r5c] DONE", flush=True)


if __name__ == "__main__":
    main()
