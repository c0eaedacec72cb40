"""Round-5 campaign part F: final validation passes.

  W6_so3_perpair   per-pair statistics for the global SO(3) initializer
                   on noisy full-SO(3) pairs: W4's 8.9-deg MEAN hides a
                   bimodal story (most pairs sub-degree, occasional
                   symmetric-twin locks on the uniform CUBE clouds whose
                   support has octahedral symmetry). Report median /
                   basin fraction / per-pair values, and the same on
                   lidar-like clouds (asymmetric support - the realistic
                   case, where twins cannot arise).
  V1_registry      pretrained.cascade("kitti-cascade") must reproduce
                   the campaign-measured numbers (registry wiring ==
                   campaign wiring).

Artifacts: artifacts/campaign_r5f/. Restart-safe.
"""

from __future__ import annotations

import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from campaign_r4_common import Campaign, wait_for_device  # noqa: E402
from campaign_r5 import eval_reg  # noqa: E402


def main():
    import jax

    TINY = os.environ.get("CAMPAIGN_TINY") == "1"
    if TINY:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from deepvcp import pretrained
    from deepvcp.data import (
        LidarLikeDataset,
        SyntheticDataset,
        batch_iterator,
    )
    from deepvcp.initializer import so3_global_init
    from deepvcp.utils.rotations import rotation_geodesic_deg

    wait_for_device()
    c = Campaign("campaign_r5f")

    N = 128 if TINY else 10000
    n_held = 2 if TINY else 16

    if not c.done("W6_so3_perpair"):
        try:
            res = {}
            sets = {
                "uniform_cube": SyntheticDataset(
                    num_clouds=n_held, num_points=N, extent=1.0,
                    seed=102, noise_std=0.01),
                "lidar_like": LidarLikeDataset(
                    num_clouds=n_held, num_points=N, max_range=1.0,
                    seed=103, noise_std=0.01),
            }
            if TINY:
                casc = None
            else:
                casc = pretrained.cascade("modelnet-cascade",
                                          num_points=N)
            for name, ds in sets.items():
                rre_init, rre_ref = [], []
                n = 0
                for srcb, tgtb, Rb, tb in batch_iterator(
                        ds, 2, epoch=0, seed=777, shuffle=False):
                    src, tgt = jnp.asarray(srcb), jnp.asarray(tgtb)
                    Rb = jnp.asarray(Rb)
                    init = so3_global_init(src, tgt)
                    rre_init += list(np.asarray(
                        rotation_geodesic_deg(init.R, Rb)))
                    if casc is not None:
                        out = casc(src, tgt, init.R, init.t)
                        rre_ref += list(np.asarray(
                            rotation_geodesic_deg(out.R, Rb)))
                    n += 1
                    if n >= 8:
                        break
                arr = np.asarray(rre_init)
                entry = {
                    "init_rre_per_pair": [round(float(x), 2)
                                          for x in arr],
                    "init_median_deg": round(float(np.median(arr)), 3),
                    "init_basin_frac_lt10": round(
                        float((arr < 10).mean()), 3),
                }
                if rre_ref:
                    ref = np.asarray(rre_ref)
                    entry.update({
                        "refined_rre_per_pair": [round(float(x), 2)
                                                 for x in ref],
                        "refined_median_deg": round(
                            float(np.median(ref)), 3),
                        "refined_frac_lt2": round(
                            float((ref < 2).mean()), 3),
                    })
                res[name] = entry
            c.save("W6_so3_perpair", res)
        except Exception:
            c.save("W6_so3_perpair", {"error": traceback.format_exc()})

    if not c.done("V1_registry") and not TINY:
        try:
            held = LidarLikeDataset(
                num_clouds=n_held, num_points=N, max_range=25.0,
                seed=110, max_rotation_deg=5.0, max_translation=0.5)
            casc = pretrained.cascade("kitti-cascade", num_points=N)
            res = {"kitti_cascade": eval_reg(casc, held),
                   "campaign_measured": {"gt_free_rre_deg": 0.447,
                                         "gt_free_rte": 0.0027}}
            c.save("V1_registry", res)
        except Exception:
            c.save("V1_registry", {"error": traceback.format_exc()})

    print("[campaign_r5f] DONE", flush=True)


if __name__ == "__main__":
    main()
