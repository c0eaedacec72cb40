"""Round-5 campaign part D: generalist retry (G2).

G1 (campaign_r5) fine-tuned modelnet-fine on a 50/50 uniform/lidar mix
at lr 1e-3 and landed at 3.14 deg uniform / 6.63 lidar (target <=2 /
<=3) — worse than BOTH specialists, the signature of an lr restart hot
enough to walk out of the pretrained basin before re-converging. G2
repeats the mix with a 3x smaller peak lr (3e-4, cosine) and the same
budget: the hypothesis is that the generalist gap is an optimization
artifact, not a capacity limit. Either way the result is committed.

Artifacts: artifacts/campaign_r5d/. Restart-safe.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from campaign_r4_common import (  # noqa: E402
    Campaign,
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
    from deepvcp.data import (
        LidarLikeDataset,
        SyntheticDataset,
        batch_iterator,
    )
    from deepvcp.registration import Registrar

    wait_for_device()
    c = Campaign("campaign_r5d")

    if TINY:
        N, n_train, n_held, BUDGET = 128, 4, 2, 0.2
    else:
        N, n_train, n_held, BUDGET = 10000, 256, 16, 25.0

    class MixedDataset:
        def __init__(self, parts):
            self.parts = parts

        def __len__(self):
            return sum(len(p) for p in self.parts)

        def sample(self, index, rng):
            part = self.parts[index % 2]
            return part.sample((index // 2) % len(part), rng)

    ext = 2.0 if TINY else 1.0
    half = max(n_train // 2, 2)
    mix = MixedDataset((
        SyntheticDataset(num_clouds=half, num_points=N, extent=ext,
                         seed=0),
        LidarLikeDataset(num_clouds=half, num_points=N, max_range=ext,
                         seed=1),
    ))
    held_g = {
        "uniform_small": SyntheticDataset(
            num_clouds=n_held, num_points=N, extent=ext, seed=100,
            max_rotation_deg=10.0, max_translation=0.5),
        "lidar_small": LidarLikeDataset(
            num_clouds=n_held, num_points=N, max_range=ext, seed=101,
            max_rotation_deg=10.0, max_translation=0.5),
    }

    if TINY:
        cfg_g = dataclasses.replace(
            DeepVCPConfig.tiny(num_points=N, use_normal=False),
            neighbor_method="banded", spatial_extent=5.0, band_tile=64)
        init_state = None
    else:
        cfg_g, _ = pretrained.load("modelnet-fine", num_points=N)

    tcfg_g = dataclasses.replace(
        residual_tcfg(rot_jitter_deg=8.0, trans_jitter=0.35),
        learning_rate=3e-4)
    spe = len(mix)
    sample = next(batch_iterator(mix, 1, epoch=0, seed=0))
    step_ms = 90.0 if TINY else 53.0
    epochs = max(min(int(BUDGET * 60e3 / step_ms) // spe, 200), 1)

    if not c.done("G2_generalist_lr3e4"):
        try:
            init_state = None
            if not TINY:
                tr_probe = load_trained(
                    Campaign("campaign_r4"), "model_fine", cfg_g,
                    residual_tcfg(rot_jitter_deg=8.0, trans_jitter=0.35),
                    1, sample, spe)
                init_state = tr_probe.state
            tr_g, res = train_model(
                c, "model_g2", cfg_g, tcfg_g, epochs, mix, held_g,
                sample, spe, init_state=init_state)
            if init_state is not None:
                del tr_probe, init_state
            v_g = variables_of(tr_g)
            sweep = {}
            for name, ds in held_g.items():
                r = Registrar(cfg_g, v_g, use_saliency_weights=True,
                              refine_iters=1 if TINY else 3, guard=True)
                sweep[name] = eval_reg(r, ds)
            res["registrar_iters3"] = sweep
            res["target_met"] = bool(
                sweep["uniform_small"]["gt_free_rre_deg"] <= 2.0
                and sweep["lidar_small"]["gt_free_rre_deg"] <= 3.0)
            c.save("G2_generalist_lr3e4", res)
            del tr_g
        except Exception:
            c.save("G2_generalist_lr3e4", {"error": traceback.format_exc()})

    # --- G3: mixture-of-experts routing (no training) ---------------------
    # G1/G2 settled that one weight set cannot serve both distributions;
    # the product answer routes each pair to its specialist
    # (pretrained.routed_registrar). Eval on the same held protocol.
    if not c.done("G3_routed") and not TINY:
        try:
            reg = pretrained.routed_registrar(num_points=N)
            sweep = {name: eval_reg(reg, ds) for name, ds in held_g.items()}
            res = {"registrar_iters3": sweep}
            res["target_met"] = bool(
                sweep["uniform_small"]["gt_free_rre_deg"] <= 2.0
                and sweep["lidar_small"]["gt_free_rre_deg"] <= 3.0)
            c.save("G3_routed", res)
        except Exception:
            c.save("G3_routed", {"error": traceback.format_exc()})

    print("[campaign_r5d] DONE", flush=True)


if __name__ == "__main__":
    main()
