"""Synthetic-pair construction: the self-supervised augmentation both
reference datasets share (ModelNet40Dataset.py:60-92, KITTIDataset.py:65-97).

Given a source cloud, the target is R @ src + t for a random rotation
(three uniform Euler angles in [0, 2pi)) and uniform translation in
[-1, 1]^3; normals rotate without translating. Everything is seeded
(numpy Generator) so pairs are reproducible — which also makes the pair
construction a test oracle (SURVEY.md §4).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from deepvcp.utils.rotations import random_bounded_rotation, random_rotation


def random_pose(
    rng: np.random.Generator,
    max_translation: float = 1.0,
    max_rotation_deg: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(R [3,3] float64, t [3] float64).

    With max_rotation_deg set, R is a bounded random rotation (geodesic
    angle uniform in [0, max_rotation_deg]) — the small-motion distribution
    for identity-init GT-free evaluation and odometry-like pairs. Default
    None keeps the reference's full-SO(3) Euler sampling."""
    if max_rotation_deg is None:
        R = np.asarray(random_rotation(rng))
    else:
        R = random_bounded_rotation(rng, max_rotation_deg)
    t = rng.uniform(-max_translation, max_translation, size=3)
    return R, t


def make_pair(
    points: np.ndarray,
    rng: np.random.Generator,
    normals: Optional[np.ndarray] = None,
    max_translation: float = 1.0,
    max_rotation_deg: Optional[float] = None,
    noise_std: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Build a registration pair from one cloud.

    Args:
        points: [N, 3] float source xyz.
        normals: optional [N, 3] normals.
        noise_std: per-point Gaussian sensor noise added to the TARGET
            after the transform (the reference's pairs are noiseless
            copies, which lets correspondence-free ICP solve them
            exactly — unrealistically; noisy pairs keep evaluation of
            the learned pipeline honest).
    Returns:
        (src [N, 3 or 6], tgt [N, 3 or 6], R [3, 3], t [3]) float32,
        channels-last.
    """
    R, t = random_pose(rng, max_translation, max_rotation_deg)
    tgt_xyz = points @ R.T + t
    if noise_std > 0.0:
        tgt_xyz = tgt_xyz + rng.normal(0.0, noise_std, tgt_xyz.shape)
    if normals is not None:
        tgt_nrm = normals @ R.T
        src = np.concatenate([points, normals], axis=-1)
        tgt = np.concatenate([tgt_xyz, tgt_nrm], axis=-1)
    else:
        src, tgt = points, tgt_xyz
    return (
        src.astype(np.float32),
        tgt.astype(np.float32),
        R.astype(np.float32),
        t.astype(np.float32),
    )


def resample(points: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    """Random subsample (without replacement when possible) to exactly n
    points (ref KITTIDataset.py:11-16; we also upsample short clouds with
    replacement so shapes stay static for XLA)."""
    m = points.shape[0]
    if m == n:
        return points
    idx = rng.choice(m, size=n, replace=m < n)
    return points[idx]
