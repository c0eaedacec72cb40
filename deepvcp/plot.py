"""Plot training curves from a metrics JSONL file (replaces loss_vis.py's
stdout scraping and the broken print_loss.py):

    python -m deepvcp.plot metrics.jsonl [--out loss.png] [--summary]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("metrics", help="metrics JSONL file")
    p.add_argument("--out", default="loss.png")
    p.add_argument("--keys", nargs="+", default=["loss", "rre_deg", "rte"])
    p.add_argument("--smooth", type=int, default=10)
    p.add_argument("--summary", action="store_true",
                   help="print per-epoch averages (print_loss.py parity)")
    args = p.parse_args(argv)

    # plotting needs no accelerator
    import jax

    jax.config.update("jax_platforms", "cpu")

    from deepvcp.train.metrics import load_metrics
    from deepvcp.utils.vis import plot_metrics

    if args.summary:
        records = load_metrics(args.metrics)
        for r in records:
            if r.get("kind") in ("epoch", "eval"):
                vals = {
                    k: round(v, 6)
                    for k, v in r.items()
                    if isinstance(v, float) and k != "ts"
                }
                print(json.dumps({"kind": r["kind"],
                                  "epoch": r.get("epoch"), **vals}))
    out = plot_metrics(
        args.metrics, args.out, keys=args.keys, smooth=args.smooth
    )
    print(f"plot saved to {out}")


if __name__ == "__main__":
    main()
