"""Visualization / export utilities (capability parity with
vis_utils.py:30-105 and loss_vis.py, minus the hard open3d dependency).

- save per-pair ground-truth / predicted clouds as .npy (vis_utils.py:99-100)
- write .pcd files directly (ASCII PCD v0.7 — no open3d needed;
  vis_utils.py:51 uses open3d only for this)
- optional interactive rendering through open3d IF installed (gated import)
- plot loss / error curves from the metrics JSONL (replaces loss_vis.py's
  stdout scraping and the broken print_loss.py)
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence

import numpy as np


def save_cloud_pair(
    out_dir: str, index: int, target_gt: np.ndarray, target_pred: np.ndarray
) -> None:
    """Write {index}_gt.npy / {index}_pred.npy ([N, 3] each),
    matching the reference's layout (vis_utils.py:99-100)."""
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"{index}_gt.npy"), np.asarray(target_gt))
    np.save(os.path.join(out_dir, f"{index}_pred.npy"), np.asarray(target_pred))


def load_cloud_pairs(out_dir: str) -> List[tuple]:
    """Read back every saved (gt, pred) pair (vis_utils.py:120-129)."""
    names = sorted(
        f for f in os.listdir(out_dir) if f.endswith("_gt.npy")
    )
    pairs = []
    for n in names:
        idx = n[: -len("_gt.npy")]
        gt = np.load(os.path.join(out_dir, n)).reshape(-1, 3)
        pred = np.load(os.path.join(out_dir, f"{idx}_pred.npy")).reshape(-1, 3)
        pairs.append((gt, pred))
    return pairs


def write_pcd(
    path: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
) -> None:
    """ASCII PCD v0.7 writer (replaces the open3d write at vis_utils.py:51).

    points: [N, 3]; colors: optional [N, 3] in [0, 1].
    """
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = pts.shape[0]
    with open(path, "w") as fh:
        fh.write("# .PCD v0.7 - Point Cloud Data file format\n")
        fh.write("VERSION 0.7\n")
        if colors is not None:
            rgb = (np.clip(np.asarray(colors), 0, 1) * 255).astype(np.uint32)
            packed = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
            fh.write("FIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F U\n")
            fh.write("COUNT 1 1 1 1\n")
        else:
            fh.write("FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n")
        fh.write(f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n")
        fh.write(f"POINTS {n}\nDATA ascii\n")
        if colors is not None:
            for p, c in zip(pts, packed):
                fh.write(f"{p[0]} {p[1]} {p[2]} {c}\n")
        else:
            for p in pts:
                fh.write(f"{p[0]} {p[1]} {p[2]}\n")


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Centroid-per-voxel downsampling (replaces open3d
    voxel_down_sample at vis_utils.py:41)."""
    pts = np.asarray(points).reshape(-1, 3)
    keys = np.floor(pts / voxel_size).astype(np.int64)
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    sums = np.zeros((inv.max() + 1, 3))
    counts = np.zeros(inv.max() + 1)
    np.add.at(sums, inv, pts)
    np.add.at(counts, inv, 1)
    return sums / counts[:, None]


def draw(point_clouds: Sequence[np.ndarray], out_path: str = "vis.pcd") -> None:
    """Render overlaid clouds (GT red, prediction blue) with open3d when
    available, else write a combined colored .pcd (vis_utils.py:30-51)."""
    colored = []
    colors = []
    palette = [(1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0)]
    for i, pc in enumerate(point_clouds):
        pc = voxel_downsample(pc, 0.01)
        colored.append(pc)
        colors.append(np.tile(palette[i % len(palette)], (pc.shape[0], 1)))
    merged = np.concatenate(colored)
    merged_colors = np.concatenate(colors)
    try:  # pragma: no cover - open3d not in the image
        import open3d as o3d

        cloud = o3d.geometry.PointCloud()
        cloud.points = o3d.utility.Vector3dVector(merged)
        cloud.colors = o3d.utility.Vector3dVector(merged_colors)
        o3d.visualization.draw_geometries([cloud])
        o3d.io.write_point_cloud(out_path, cloud)
    except ImportError:
        write_pcd(out_path, merged, merged_colors)


def plot_voxel_candidates(
    keypoints: np.ndarray,
    candidates: np.ndarray,
    out_path: str = "voxelization.png",
    max_points: int = 8,
) -> str:
    """3-D scatter of candidate voxel grids around keypoints (capability
    parity with the reference's visualize_voxelization, voxelize.py:86-114,
    which renders each point's grid with matplotlib).

    keypoints [K, 3]; candidates [K, C, 3] (ops.voxelize output).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    kp = np.asarray(keypoints)[:max_points]
    cand = np.asarray(candidates)[:max_points]
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    for i in range(kp.shape[0]):
        ax.scatter(*cand[i].T, s=2, alpha=0.3)
        ax.scatter(*kp[i], s=40, marker="x", color="black")
    ax.set_title("candidate voxel grids")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_metrics(
    metrics_path: str,
    out_path: str = "loss.png",
    keys: Iterable[str] = ("loss", "rre_deg", "rte"),
    smooth: int = 10,
) -> str:
    """Plot training curves from the metrics JSONL (replaces loss_vis.py's
    stdout scraping; `smooth` is the per-10-batch averaging it did at
    loss_vis.py:27-38)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from deepvcp.train.metrics import load_metrics

    records = [r for r in load_metrics(metrics_path) if r.get("kind") == "train"]
    keys = [k for k in keys if any(k in r for r in records)]
    fig, axes = plt.subplots(1, max(len(keys), 1), figsize=(5 * len(keys), 4))
    if len(keys) == 1:
        axes = [axes]
    for ax, k in zip(axes, keys):
        ys = np.asarray([r[k] for r in records if k in r], dtype=np.float64)
        if smooth > 1 and len(ys) >= smooth:
            ys = ys[: len(ys) - len(ys) % smooth].reshape(-1, smooth).mean(1)
        ax.plot(ys)
        ax.set_title(k)
        ax.set_xlabel(f"batch / {smooth}")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path
