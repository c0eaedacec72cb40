"""Accuracy demonstration: train on synthetic registration pairs and watch
RRE/RTE drop (the self-supervised pair construction is its own oracle —
SURVEY.md §4).

    python examples/train_synthetic.py --steps 200 --num-points 2048 [--cpu]

Writes metrics to the given JSONL and prints a start/end summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# runnable as `python examples/train_synthetic.py` without installing
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--num-points", type=int, default=2048)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--metrics", default="synthetic_metrics.jsonl")
    args = p.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from deepvcp import DeepVCPConfig
    from deepvcp.config import TrainConfig
    from deepvcp.data import SyntheticDataset, batch_iterator
    from deepvcp.train import MetricsLogger, Trainer

    model_cfg = (
        DeepVCPConfig.tiny(args.num_points, use_normal=False)
        if args.tiny
        else DeepVCPConfig(
            num_points=args.num_points,
            use_normal=False,
            spatial_extent=20.0,
        )
    )
    train_cfg = TrainConfig(
        batch_size=args.batch_size,
        learning_rate=args.lr,
        metrics_path=args.metrics,
        log_every=10,
        use_saliency_weights=False,
    )
    ds = SyntheticDataset(
        num_clouds=64, num_points=args.num_points, extent=10.0, seed=0
    )
    trainer = Trainer(model_cfg, train_cfg, MetricsLogger(args.metrics, echo=False))
    batch = next(batch_iterator(ds, args.batch_size, epoch=0, seed=0))
    trainer.setup(batch)

    first = None
    window = []
    t0 = time.time()
    step = 0
    epoch = 0
    while step < args.steps:
        for b in batch_iterator(ds, args.batch_size, epoch=epoch, seed=0):
            trainer.state, m = trainer._train_step(
                trainer.state, *(jnp.asarray(a) for a in b)
            )
            m = {k: float(v) for k, v in m.items()}
            trainer.metrics.log({"kind": "train", "step": step, **m})
            if first is None:
                first = m
            window.append(m)
            window = window[-20:]
            step += 1
            if step % 20 == 0:
                avg = {
                    k: float(np.mean([w[k] for w in window]))
                    for k in ("loss", "rre_deg", "rte")
                }
                print(
                    f"step {step}: loss {avg['loss']:.4f} "
                    f"rre {avg['rre_deg']:.3f}deg rte {avg['rte']:.3f}",
                    flush=True,
                )
            if step >= args.steps:
                break
        epoch += 1

    last = {
        k: float(np.mean([w[k] for w in window]))
        for k in ("loss", "rre_deg", "rte")
    }
    wall = time.time() - t0
    summary = {
        "steps": args.steps,
        "steps_per_sec": round(args.steps / wall, 3),
        "pairs_per_sec_train": round(args.steps * args.batch_size / wall, 3),
        "first": {k: round(first[k], 4) for k in ("loss", "rre_deg", "rte")},
        "last": {k: round(last[k], 4) for k in ("loss", "rre_deg", "rte")},
    }
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
