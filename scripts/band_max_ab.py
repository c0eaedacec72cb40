"""The band-max kernel against the XLA static band, alone and end to end.

Alone: both engines of models/fused_sa.banded_max_pool, forward and
forward + backward, at N=10 000 on the SA stages' (radius, channels) at
ModelNet extent (2.5, uniform cloud) and KITTI extent (55, lidar-like
scan), plus a sweep of the kernel's block sizes.

End to end: the kitti25 and modelnet-fine registrars (N=10 000, B=1)
and a kitti-scale train step (B=2), once with each engine, in the order
kernel, XLA, XLA, kernel. Prints the card, then one JSON line per
measurement (median milliseconds).

    python scripts/band_max_ab.py [--sweep]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def median_ms(fn, *args, n=10):
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def alone(sweep: bool):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from deepvcp.data.datasets import lidar_like_cloud
    from deepvcp.models import fused_sa
    from deepvcp.ops.neighbors import window_for
    from deepvcp.ops.pallas import banded_masked_max

    N = 10000
    rng = np.random.default_rng(0)
    for extent in (2.5, 55.0):
        if extent < 10:
            xyz = rng.uniform(-1, 1, (N, 3))
        else:
            xyz = lidar_like_cloud(rng, N, max_range=25.0)
        xyz = jnp.asarray(xyz[np.argsort(xyz[:, 0])][None]
                          .astype(np.float32))
        for r, C in ((0.1, 16), (0.2, 32), (0.4, 64)):
            u = jnp.asarray(rng.standard_normal((1, N, C)).astype(np.float32))
            win = window_for(N, r, extent, 4.0)
            row = {"what": "alone", "extent": extent, "radius": r, "C": C,
                   "window": win}
            for engine in ("triton", "xla_band"):
                fused_sa.pooling_engine = lambda e=engine: e
                fwd = jax.jit(lambda x, v: fused_sa.banded_max_pool(
                    x, v, r, win, 256))
                both = jax.jit(jax.value_and_grad(lambda v, x: jnp.sum(
                    jnp.sin(fused_sa.banded_max_pool(x, v, r, win, 256)))))
                row[f"{engine}_fwd_ms"] = median_ms(fwd, xyz, u)
                row[f"{engine}_fwd_bwd_ms"] = median_ms(both, u, xyz)
            print(json.dumps(row), flush=True)
            if not sweep:
                continue
            for w in (16, 32, 64):
                for cb in (16, 32, 64):
                    if cb > C:
                        continue
                    for warps in (1, 2, 4):
                        t = median_ms(jax.jit(lambda x, v: banded_masked_max(
                            x, v, r, w=w, cb=cb, num_warps=warps)), xyz, u,
                            n=5)
                        print(json.dumps({"what": "sweep", "extent": extent,
                                          "C": C, "w": w, "cb": cb,
                                          "num_warps": warps, "fwd_ms": t}),
                              flush=True)


def end_to_end():
    import jax
    import jax.numpy as jnp
    import optax

    from deepvcp import DeepVCPConfig, pretrained
    from deepvcp.config import TrainConfig
    from deepvcp.data import LidarLikeDataset, SyntheticDataset, \
        batch_iterator
    from deepvcp.models import DeepVCP, fused_sa
    from deepvcp.train.trainer import create_train_state, make_train_step

    N = 10000
    lidar = LidarLikeDataset(num_clouds=2, num_points=N, max_range=25.0,
                             seed=1, max_rotation_deg=5.0,
                             max_translation=0.5)
    uniform = SyntheticDataset(num_clouds=1, num_points=N, extent=1.0,
                               seed=2, max_rotation_deg=10.0,
                               max_translation=0.5)
    kitti = [jnp.asarray(a) for a in next(batch_iterator(lidar, 1))]
    mnet = [jnp.asarray(a) for a in next(batch_iterator(uniform, 1))]
    batch2 = [jnp.asarray(a) for a in next(batch_iterator(lidar, 2))]

    def workloads():
        reg_k = pretrained.registrar("kitti25", num_points=N)
        reg_m = pretrained.registrar("modelnet-fine", num_points=N)
        model = DeepVCP(cfg=DeepVCPConfig.kitti_scale(N))
        tcfg = TrainConfig(batch_size=2)
        state, tx = create_train_state(model, tcfg, batch2)
        step = make_train_step(model, tx, tcfg)
        holder = {"state": state}

        def train_once():
            holder["state"], m = step(holder["state"], *batch2)
            return m["loss"]

        return {
            "kitti25": lambda: reg_k(kitti[0], kitti[1]).R,
            "modelnet-fine": lambda: reg_m(mnet[0], mnet[1]).R,
            "train_step_kitti_b2": train_once,
        }

    built = {}
    for engine in ("triton", "xla_band", "xla_band", "triton"):
        fused_sa.pooling_engine = lambda e=engine: e
        if engine not in built:
            built[engine] = workloads()
        for name, fn in built[engine].items():
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            first = time.perf_counter() - t0
            print(json.dumps({"what": "e2e", "engine": engine,
                              "workload": name, "ms": median_ms(fn),
                              "first_call_s": first}), flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--skip-e2e", action="store_true")
    args = p.parse_args()

    import jax

    from deepvcp.utils.cache import enable_compile_cache
    from deepvcp.utils.device import card_name_and_power_limit

    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit("needs a GPU")
    print(card_name_and_power_limit(), flush=True)
    alone(args.sweep)
    if not args.skip_e2e:
        end_to_end()


if __name__ == "__main__":
    main()
