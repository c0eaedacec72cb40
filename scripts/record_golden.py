"""Record the model's golden outputs into tests/data/golden_model.npz.

The committed archive was recorded from the Flax implementation that
deepvcp.models.nn replaced, on the CPU at Precision.HIGHEST; the tests
in tests/test_golden.py hold the module layer to it. It holds:

- "tiny/...": DeepVCPConfig.tiny() with random-init variables (stored),
  its inputs, and DeepVCP.apply's outputs;
- "kitti25/...": the kitti25 registry checkpoint (weights from its
  .npz) on a 256-point lidar-like pair, inputs and outputs;
- "train/...": one training step of the tiny model at B=2 from the
  stored variables: the loss and the gradient norm.

    JAX_PLATFORMS=cpu python scripts/record_golden.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "data", "golden_model.npz")


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from deepvcp import DeepVCPConfig, pretrained
    from deepvcp.config import TrainConfig
    from deepvcp.data import LidarLikeDataset, batch_iterator
    from deepvcp.models import DeepVCP
    from deepvcp.train.trainer import TrainState, build_train_step
    from deepvcp.utils import random_rotation
    from deepvcp.utils.checkpoint import flatten

    import optax

    rec = {}
    with jax.default_matmul_precision("highest"):
        # tiny config, random init
        cfg = DeepVCPConfig.tiny(num_points=96)
        model = DeepVCP(cfg=cfg)
        rng = np.random.default_rng(0)
        src = rng.uniform(-1, 1, (2, 96, 6)).astype(np.float32)
        tgt = rng.uniform(-1, 1, (2, 96, 6)).astype(np.float32)
        R = np.stack([random_rotation(rng) for _ in range(2)]
                     ).astype(np.float32)
        t = rng.uniform(-0.3, 0.3, (2, 3)).astype(np.float32)
        variables = model.init(jax.random.key(0), src, tgt, R, t)
        variables = jax.tree_util.tree_map(np.asarray, dict(variables))
        kp, vcp, aux = model.apply(variables, src, tgt, R, t)
        rec.update({f"tiny/variables/{k}": v
                    for k, v in flatten(variables).items()})
        rec.update({"tiny/src": src, "tiny/tgt": tgt, "tiny/R": R,
                    "tiny/t": t, "tiny/kp": kp, "tiny/vcp": vcp,
                    "tiny/saliency": aux["saliency"],
                    "tiny/candidate_weights": aux["candidate_weights"]})

        # one registry checkpoint
        cfg_k, var_k = pretrained.load("kitti25", num_points=256)
        ds = LidarLikeDataset(num_clouds=1, num_points=256, max_range=25.0,
                              seed=3, max_rotation_deg=5.0,
                              max_translation=0.5)
        s, g, Rk, tk = next(batch_iterator(ds, 1, epoch=0, seed=0))
        kp_k, vcp_k, _ = DeepVCP(cfg=cfg_k).apply(var_k, s, g, Rk, tk)
        rec.update({"kitti25/src": s, "kitti25/tgt": g, "kitti25/R": Rk,
                    "kitti25/t": tk, "kitti25/kp": kp_k,
                    "kitti25/vcp": vcp_k})

        # one train step from the stored tiny variables
        tcfg = TrainConfig()
        tx = optax.adam(tcfg.learning_rate)
        state = TrainState(params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]),
                           step=jnp.zeros((), jnp.int32))
        step = build_train_step(model, tx, tcfg)
        _, metrics = jax.jit(step)(state, src, tgt, R, t)
        rec["train/loss"] = metrics["loss"]
        rec["train/grad_norm"] = metrics["grad_norm"]

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez(OUT, **{k: np.asarray(v) for k, v in rec.items()})
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes): "
          f"loss {float(rec['train/loss']):.6f}")


if __name__ == "__main__":
    main()
