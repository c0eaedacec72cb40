"""Odometry CLI:

    python -m deepvcp.odometry --root /data/kitti --sequence 00 \
        --checkpoint ckpt/final --max-frames 200
"""

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="KITTI sequence odometry")
    p.add_argument("--root", required=True, help="KITTI odometry root")
    p.add_argument("--sequence", default="00")
    p.add_argument("--checkpoint", default=None,
                   help="trained checkpoint (omit for random init smoke run)")
    p.add_argument("--num-points", type=int, default=10000)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--no-optimize", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--out", default="trajectory.npz")
    args = p.parse_args(argv)

    seq_dir = os.path.join(args.root, "sequences", args.sequence, "velodyne")
    if not os.path.isdir(seq_dir):
        # validate before any jax work so path errors surface cleanly
        sys.exit(f"error: no velodyne scans at {seq_dir}")

    import jax

    from deepvcp import DeepVCPConfig, pretrained
    from deepvcp.models import DeepVCP
    from deepvcp.odometry import (
        load_kitti_poses,
        load_sequence_scans,
        run_odometry,
    )
    from deepvcp.registration import Registrar
    from deepvcp.utils.cache import enable_compile_cache
    import jax.numpy as jnp

    enable_compile_cache()

    cfg = (
        DeepVCPConfig.tiny(args.num_points, use_normal=False)
        if args.tiny
        else DeepVCPConfig(num_points=args.num_points, use_normal=False)
    )
    model = DeepVCP(cfg=cfg)
    scans = load_sequence_scans(
        args.root, args.sequence, cfg.num_points, args.max_frames
    )
    print(f"loaded {scans.shape[0]} frames of {scans.shape[1]} points")

    if args.checkpoint:
        variables = pretrained.load_variables(
            os.path.abspath(args.checkpoint))
    else:
        variables = model.init(
            jax.random.key(0),
            jnp.asarray(scans[:1]),
            jnp.asarray(scans[:1]),
            jnp.eye(3)[None],
            jnp.zeros((1, 3)),
        )

    gt = None
    pose_file = os.path.join(args.root, "poses", f"{args.sequence}.txt")
    if os.path.exists(pose_file):
        gt = load_kitti_poses(pose_file)

    reg = Registrar(cfg, variables)
    result = run_odometry(
        reg,
        scans,
        gt_poses=gt,
        optimize=not args.no_optimize,
        batch_size=args.batch_size,
    )
    np.savez(
        args.out,
        **{k: v for k, v in result.items() if isinstance(v, np.ndarray)},
    )
    metrics = {
        k: v for k, v in result.items() if not isinstance(v, np.ndarray)
    }
    print(json.dumps({"frames": int(scans.shape[0]), **metrics}))
    print(f"trajectory saved to {args.out}")


if __name__ == "__main__":
    main()
