"""KITTI sequence odometry pipeline: register consecutive frames with a
trained DeepVCP model, chain into a trajectory, optimize the pose graph,
and evaluate ATE/RPE against ground-truth poses when available.

BASELINE.json config 4: "KITTI sequence odometry: chained pairwise
registration + pose-graph optimization over a full sequence."
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from deepvcp.data.datasets import read_velodyne_bin
from deepvcp.data.transforms import resample
from deepvcp.odometry.pose_graph import (
    absolute_trajectory_error,
    build_graph,
    chain_poses,
    optimize_pose_graph,
    relative_pose_errors,
)
from deepvcp.registration import Registrar


def load_kitti_poses(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI odometry ground-truth pose file: each row is a 3x4 [R|t]
    mapping frame i into frame 0. Returns (R [F,3,3], t [F,3])."""
    raw = np.loadtxt(path).reshape(-1, 3, 4)
    return raw[:, :, :3], raw[:, :, 3]


def load_sequence_scans(
    root: str,
    sequence: str,
    num_points: int,
    max_frames: Optional[int] = None,
    seed: int = 0,
) -> np.ndarray:
    """[F, num_points, 3] downsampled velodyne scans of one sequence."""
    vdir = os.path.join(root, "sequences", sequence, "velodyne")
    files = sorted(os.listdir(vdir))[:max_frames]
    rng = np.random.default_rng(seed)
    scans = []
    for f in files:
        scan = read_velodyne_bin(os.path.join(vdir, f))[:, :3]
        scans.append(resample(scan, num_points, rng).astype(np.float32))
    return np.stack(scans)


def register_sequence(
    registrar: Registrar,
    scans: np.ndarray,
    batch_size: int = 1,
    warm_start: bool = True,
    stream_depth: int = 4,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pairwise-register consecutive frames (src=i, tgt=i+1).

    With `warm_start` (default), pair i+1 is initialized with pair i's
    SOLVED pose — the constant-velocity motion prior (the model input the
    reference computes but never uses at inference, deepVCP.py:86-92 /
    train.py:104-105). This is what makes routine inter-frame motion
    tractable: the candidate grid only reaches ~(search_radius +
    voxel_len/2) around the warm-started keypoints, so identity init fails
    outright once per-frame motion exceeds grid reach, while the prior only
    has to absorb the per-frame *acceleration*. The data dependence makes
    this path sequential (batch_size is ignored).

    With warm_start=False, frames are identity-initialized, grouped into
    `batch_size`-pair batches (the last batch padded to keep one compiled
    shape), and pipelined through Registrar.stream (depth `stream_depth`)
    — the high-throughput mode for pre-aligned or small-motion sequences.
    The warm-start path is inherently sequential, so batch_size only
    applies here.

    Returns relative poses (R_rel [F-1, 3, 3], t_rel [F-1, 3]) with
    x_{i+1} ~= R_rel[i] x_i + t_rel[i].
    """
    F = scans.shape[0]
    if warm_start:
        R_out, t_out = [], []
        R_prev = np.eye(3, dtype=np.float32)
        t_prev = np.zeros(3, dtype=np.float32)
        for i in range(F - 1):
            out = registrar(
                jnp.asarray(scans[i : i + 1]),
                jnp.asarray(scans[i + 1 : i + 2]),
                R_init=jnp.asarray(R_prev[None]),
                t_init=jnp.asarray(t_prev[None]),
            )
            R_prev = np.asarray(out.R)[0]
            t_prev = np.asarray(out.t)[0]
            R_out.append(R_prev)
            t_out.append(t_prev)
        return np.stack(R_out), np.stack(t_out)

    src_idx = np.arange(F - 1)

    def batches():
        for start in range(0, F - 1, batch_size):
            idx = src_idx[start : start + batch_size]
            src, tgt = scans[idx], scans[idx + 1]
            pad = batch_size - len(idx)
            if pad:
                src = np.concatenate([src, src[-1:].repeat(pad, axis=0)])
                tgt = np.concatenate([tgt, tgt[-1:].repeat(pad, axis=0)])
            yield jnp.asarray(src), jnp.asarray(tgt)

    R_out, t_out = [], []
    n_left = F - 1
    for out in registrar.stream(batches(), depth=stream_depth):
        take = min(batch_size, n_left)
        n_left -= take
        R_out.append(np.asarray(out.R)[:take])
        t_out.append(np.asarray(out.t)[:take])
    return np.concatenate(R_out), np.concatenate(t_out)


def run_odometry(
    registrar: Registrar,
    scans: np.ndarray,
    gt_poses: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    optimize: bool = True,
    gn_iters: int = 20,
    batch_size: int = 1,
    warm_start: bool = True,
) -> dict:
    """Full odometry run. Returns a dict with the trajectory and metrics."""
    R_rel, t_rel = register_sequence(
        registrar, scans, batch_size, warm_start=warm_start
    )
    R_abs, t_abs = chain_poses(jnp.asarray(R_rel), jnp.asarray(t_rel))
    result = {
        "R_rel": R_rel,
        "t_rel": t_rel,
        "R_abs": np.asarray(R_abs),
        "t_abs": np.asarray(t_abs),
    }
    if optimize:
        graph = build_graph(jnp.asarray(R_rel), jnp.asarray(t_rel))
        R_opt, t_opt = optimize_pose_graph(
            graph, jnp.asarray(R_abs), jnp.asarray(t_abs), num_iters=gn_iters
        )
        result["R_opt"] = np.asarray(R_opt)
        result["t_opt"] = np.asarray(t_opt)
    if gt_poses is not None:
        R_gt, t_gt = gt_poses
        F = scans.shape[0]
        R_gt, t_gt = R_gt[:F], t_gt[:F]
        t_est = result.get("t_opt", result["t_abs"])
        R_est = result.get("R_opt", result["R_abs"])
        result["ate_rmse"] = float(
            absolute_trajectory_error(jnp.asarray(t_est), jnp.asarray(t_gt))
        )
        ang, dt = relative_pose_errors(
            jnp.asarray(R_est), jnp.asarray(t_est),
            jnp.asarray(R_gt), jnp.asarray(t_gt),
        )
        result["rpe_rot_deg_mean"] = float(jnp.mean(ang))
        result["rpe_trans_mean"] = float(jnp.mean(dt))
    return result
