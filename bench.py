"""Headline benchmark: end-to-end registration pairs/sec on one chip.

Measures the full inference path (DeepVCP forward + ground-truth-free
two-pass SVD pose solve) at the reference's full operating point:
N=10000-point KITTI-scale clouds, K=64 keypoints, C=216 candidates, 32
neighbors (ref train.py:58, deepVCP.py:33,54,76-77).

Baseline: the DeepVCP paper reports ~2 s per registered frame pair on a
GTX 1080 Ti (BASELINE.md), i.e. 0.5 pairs/s.

Prints the card's name and power limit, then ONE JSON line: {"metric",
"value", "unit", "vs_baseline", "device"}. It fails when JAX finds no GPU,
unless --cpu is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

BASELINE_PAIRS_PER_SEC = 0.5  # paper: ~2 s/pair on GTX 1080 Ti


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--num-points", type=int, default=10000)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (no device numbers)")
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from deepvcp.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if not args.cpu:
        if dev.platform != "gpu":
            sys.exit(f"no GPU found (JAX sees {dev.platform}); pass --cpu "
                     f"to run on the CPU")
        from deepvcp.utils.device import card_name_and_power_limit

        print(card_name_and_power_limit())

    import jax.numpy as jnp

    from deepvcp import DeepVCPConfig
    from deepvcp.data import SyntheticDataset, batch_iterator
    from deepvcp.models import DeepVCP
    from deepvcp.registration import Registrar

    cfg = DeepVCPConfig(num_points=args.num_points, use_normal=False)
    model = DeepVCP(cfg=cfg)

    ds = SyntheticDataset(
        num_clouds=args.batch,
        num_points=cfg.num_points,
        use_normal=False,
        extent=10.0,
    )
    src, tgt, R, t = next(batch_iterator(ds, args.batch, epoch=0, seed=0))
    src, tgt = jnp.asarray(src), jnp.asarray(tgt)

    t0 = time.time()
    variables = jax.jit(model.init, static_argnames=("train",))(
        jax.random.key(0), src, tgt, jnp.asarray(R), jnp.asarray(t),
        train=False,
    )
    jax.block_until_ready(variables)
    print(f"init: {time.time() - t0:.1f}s", file=sys.stderr)

    reg = Registrar(cfg, variables)

    import numpy as np

    def run_sync():
        # fetch the pose to host: one request end to end
        return np.asarray(reg(src, tgt).R)

    t0 = time.time()
    run_sync()
    print(f"compile + first run: {time.time() - t0:.1f}s", file=sys.stderr)

    for _ in range(max(args.warmup - 1, 0)):
        run_sync()

    # per-call latency (includes one device-to-host copy per call)
    times = []
    for _ in range(args.iters):
        t0 = time.time()
        run_sync()
        times.append(time.time() - t0)
    print(
        f"per-call latency best: {min(times)*1e3:.1f} ms "
        f"({args.batch / min(times):.2f} pairs/s); per-call times: "
        f"{[f'{x:.3f}' for x in times]}",
        file=sys.stderr,
    )

    # steady-state throughput: a stream of registrations dispatched
    # back-to-back (async), one sync at the end — the serving-rate metric.
    # Each call still runs the full device graph; only the per-call host
    # round trip is amortized.
    stream = max(args.iters * 2, 10)
    run_sync()
    best = None
    for _ in range(3):
        t0 = time.time()
        out = None
        for _ in range(stream):
            out = reg(src, tgt)
        jax.block_until_ready(out.R)
        dt = (time.time() - t0) / stream
        best = dt if best is None else min(best, dt)
    pairs_per_sec = args.batch / best
    print(
        json.dumps(
            {
                "metric": "registration_pairs_per_sec",
                "value": round(pairs_per_sec, 3),
                "unit": "pairs/s",
                "vs_baseline": round(pairs_per_sec / BASELINE_PAIRS_PER_SEC, 2),
                "device": {"platform": dev.platform,
                           "kind": dev.device_kind,
                           "count": len(jax.devices())},
            }
        )
    )


if __name__ == "__main__":
    main()
