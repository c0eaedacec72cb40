"""Inference walkthrough: register two point clouds with the shipped
checkpoints — the user story the reference never provides (its eval
script is broken and initializes from the ground-truth pose;
model_eval.py / vis_utils.py:79-96).

    python examples/register_pair.py [--cpu] [--num-points 2048]
                                     [--full-so3] [--kitti]

Demonstrates, in order:
  1. one-call registration with a named pretrained model,
  2. the coarse-to-fine cascade (pretrained.cascade),
  3. unrestricted SO(3): so3_global_init feeding the cascade.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--num-points", type=int, default=2048)
    p.add_argument("--full-so3", action="store_true",
                   help="unrestricted rotations + the global initializer")
    p.add_argument("--kitti", action="store_true",
                   help="use the KITTI-scale cascade on lidar-like clouds")
    args = p.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from deepvcp import pretrained
    from deepvcp.data import (
        LidarLikeDataset,
        SyntheticDataset,
        batch_iterator,
    )
    from deepvcp.utils.rotations import rotation_geodesic_deg

    N = args.num_points
    if args.kitti:
        ds = LidarLikeDataset(num_clouds=2, num_points=N, max_range=25.0,
                              seed=7, max_rotation_deg=5.0,
                              max_translation=0.5)
        reg = pretrained.cascade("kitti-cascade", num_points=N)
    elif args.full_so3:
        ds = SyntheticDataset(num_clouds=2, num_points=N, extent=1.0,
                              seed=7, noise_std=0.01)  # any rotation
        reg = pretrained.cascade("modelnet-cascade", num_points=N)
    else:
        ds = SyntheticDataset(num_clouds=2, num_points=N, extent=1.0,
                              seed=7, max_rotation_deg=10.0,
                              max_translation=0.5)
        reg = pretrained.registrar("modelnet-fine", num_points=N)

    src, tgt, R_gt, t_gt = (
        jnp.asarray(a) for a in next(batch_iterator(ds, 2, epoch=0, seed=0))
    )

    R_init = t_init = None
    if args.full_so3:
        from deepvcp.initializer import so3_global_init

        init = so3_global_init(src, tgt)
        R_init, t_init = init.R, init.t
        print("global init RRE:",
              np.asarray(rotation_geodesic_deg(init.R, R_gt)))

    out = reg(src, tgt, R_init, t_init)

    rre = np.asarray(rotation_geodesic_deg(out.R, R_gt))
    rte = np.asarray(jnp.linalg.norm(out.t - t_gt, axis=-1))
    print(f"RRE (deg): {rre}")
    print(f"RTE:       {rte}")
    print(f"guard scores (col 0 = init): {np.asarray(out.scores)}")
    print(f"keypoints {out.keypoints.shape}, vcps {out.vcps.shape}")


if __name__ == "__main__":
    main()
