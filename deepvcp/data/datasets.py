"""Datasets: ModelNet40, KITTI odometry, and a synthetic fallback.

Host-side numpy pipelines (L5 replacement; ref ModelNet40Dataset.py,
KITTIDataset.py) feeding channels-last [B, N, C] batches to the device.
Each dataset exposes `__len__` and `sample(index, rng) -> RegistrationPair`;
`batch_iterator` stacks samples, optionally shards the batch across hosts,
and seeds augmentation per (epoch, index) so every pair is reproducible.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deepvcp.data.transforms import make_pair, resample


@dataclasses.dataclass
class RegistrationPair:
    src: np.ndarray   # [N, 3 or 6]
    tgt: np.ndarray   # [N, 3 or 6]
    R: np.ndarray     # [3, 3]
    t: np.ndarray     # [3]


class ModelNet40Dataset:
    """ModelNet40 'normal_resampled' layout (ref ModelNet40Dataset.py:12-92).

    Root contains `modelnet10_shape_names.txt`, `modelnet10_{split}.txt`
    (or `modelnet10_small_{split}.txt` when full_dataset=False) and
    `<category>/<name>.txt` CSVs of x,y,z,nx,ny,nz rows. Clouds are loaded
    eagerly into RAM like the reference; pairs are synthesized on the fly.
    """

    def __init__(
        self,
        root: str,
        split: str = "train",
        full_dataset: bool = True,
        num_points: Optional[int] = None,
        use_normal: bool = True,
        max_translation: float = 1.0,
    ):
        self.root = root
        self.use_normal = use_normal
        self.num_points = num_points
        self.max_translation = max_translation
        list_name = (
            f"modelnet10_{split}.txt"
            if full_dataset
            else f"modelnet10_small_{split}.txt"
        )
        names = np.loadtxt(os.path.join(root, list_name), dtype=str).reshape(-1)
        self.points: List[np.ndarray] = []
        self.normals: List[np.ndarray] = []
        self.labels: List[str] = []
        for name in names:
            category = str(name).rsplit("_", 1)[0]
            path = os.path.join(root, category, f"{name}.txt")
            data = np.loadtxt(path, delimiter=",", dtype=np.float64)
            self.points.append(data[:, :3])
            self.normals.append(data[:, 3:6])
            self.labels.append(str(name))

    def __len__(self) -> int:
        return len(self.points)

    def sample(self, index: int, rng: np.random.Generator) -> RegistrationPair:
        pts, nrm = self.points[index], self.normals[index]
        if self.num_points is not None and pts.shape[0] != self.num_points:
            both = resample(
                np.concatenate([pts, nrm], axis=-1), self.num_points, rng
            )
            pts, nrm = both[:, :3], both[:, 3:]
        src, tgt, R, t = make_pair(
            pts,
            rng,
            normals=nrm if self.use_normal else None,
            max_translation=self.max_translation,
        )
        return RegistrationPair(src, tgt, R, t)


def read_velodyne_bin(path: str) -> np.ndarray:
    """KITTI velodyne scan: float32 [N, 4] (x, y, z, reflectance)
    (ref KITTIDataset.py:39)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


class KITTIDataset:
    """KITTI odometry velodyne scans (ref KITTIDataset.py:18-97).

    Root contains `sequences/<seq>/velodyne/*.bin`. Like the reference,
    scans are downsampled to `num_points` and pairs are synthesized with a
    random pose (no consecutive-frame pairing — that lives in odometry/).
    `files_per_seq` mirrors the reference's first-50-scans cap
    (KITTIDataset.py:33); pass None for all scans.

    `split` partitions the data (the reference accepts but ignores an
    equivalent argument — its splitting never happened):
      - "all": every scan of every sequence;
      - "train"/"test" with >= 2 sequences: sequence-based (the odometry
        convention) — train gets all sequences but the last, test gets the
        last;
      - "train"/"test" with a single sequence: scan-based 80/20 within it.
    """

    def __init__(
        self,
        root: str,
        sequences: Sequence[str] = ("00", "01", "02", "03"),
        split: str = "all",
        num_points: int = 10000,
        files_per_seq: Optional[int] = 50,
        max_translation: float = 1.0,
        eager: bool = False,
        seed: int = 0,
    ):
        if split not in ("all", "train", "test"):
            raise ValueError(f"split must be all/train/test, got {split!r}")
        self.root = root
        self.split = split
        self.num_points = num_points
        self.max_translation = max_translation
        scan_split = split != "all" and len(sequences) == 1
        if split != "all" and len(sequences) > 1:
            sequences = (
                tuple(sequences[:-1]) if split == "train"
                else (sequences[-1],)
            )
        self.sequences = tuple(sequences)
        self.files: List[str] = []
        for seq in self.sequences:
            vdir = os.path.join(root, "sequences", seq, "velodyne")
            names = sorted(os.listdir(vdir))[:files_per_seq]
            if scan_split:
                cut = max(int(len(names) * 0.8), 1)
                names = names[:cut] if split == "train" else names[cut:]
            self.files.extend(os.path.join(vdir, n) for n in names)
        if not self.files:
            raise ValueError(
                f"KITTIDataset split={split!r} over sequences "
                f"{self.sequences} selected zero scans (too few files for "
                f"a scan-based split?)"
            )
        self._cache: dict = {}
        self._downsample_rng = np.random.default_rng(seed)
        if eager:
            for i in range(len(self.files)):
                self._load(i)

    def _load(self, index: int) -> np.ndarray:
        if index not in self._cache:
            from deepvcp import native

            if native.available():
                # native C++ read + downsample (native/pointcloud.cc)
                self._cache[index] = native.velodyne_load_downsample(
                    self.files[index], self.num_points, seed=index
                ).astype(np.float64)
            else:
                scan = read_velodyne_bin(self.files[index])
                self._cache[index] = resample(
                    scan[:, :3].astype(np.float64),
                    self.num_points,
                    self._downsample_rng,
                )
        return self._cache[index]

    def __len__(self) -> int:
        return len(self.files)

    def sample(self, index: int, rng: np.random.Generator) -> RegistrationPair:
        pts = self._load(index)
        src, tgt, R, t = make_pair(
            pts, rng, normals=None, max_translation=self.max_translation
        )
        return RegistrationPair(src, tgt, R, t)


class SyntheticDataset:
    """Random uniform clouds — for tests, benchmarks, and smoke training
    without any dataset on disk. Mirrors the clouds' scale to KITTI-ish
    extents by default.

    `max_rotation_deg` bounds the synthetic pair's rotation (None = the
    reference's full-SO(3) distribution); small values give the
    odometry-like small-motion pairs that identity-init GT-free
    registration requires (the candidate grid only reaches
    search_radius + voxel_len/2 around the warm-started keypoints)."""

    def __init__(
        self,
        num_clouds: int = 64,
        num_points: int = 10000,
        use_normal: bool = False,
        extent: float = 10.0,
        max_translation: float = 1.0,
        max_rotation_deg: Optional[float] = None,
        noise_std: float = 0.0,
        seed: int = 0,
    ):
        rng = np.random.default_rng(seed)
        self.clouds = [
            rng.uniform(-extent, extent, size=(num_points, 3))
            for _ in range(num_clouds)
        ]
        self.normals = None
        if use_normal:
            n = rng.standard_normal((num_clouds, num_points, 3))
            self.normals = n / np.linalg.norm(n, axis=-1, keepdims=True)
        self.max_translation = max_translation
        self.max_rotation_deg = max_rotation_deg
        self.noise_std = noise_std

    def __len__(self) -> int:
        return len(self.clouds)

    def sample(self, index: int, rng: np.random.Generator) -> RegistrationPair:
        nrm = self.normals[index] if self.normals is not None else None
        src, tgt, R, t = make_pair(
            self.clouds[index], rng, normals=nrm,
            max_translation=self.max_translation,
            max_rotation_deg=self.max_rotation_deg,
            noise_std=self.noise_std,
        )
        return RegistrationPair(src, tgt, R, t)


def lidar_like_cloud(
    rng: np.random.Generator,
    num_points: int,
    max_range: float = 10.0,
    min_range: Optional[float] = None,
    ground_fraction: float = 0.6,
    num_clusters: int = 12,
) -> np.ndarray:
    """A velodyne-like cloud with a strong radial density gradient.

    Real spinning-LiDAR scans have point density ~ 1/range^2 (uniform
    angular sampling), giving ~100x density variation between near and far
    returns (KITTIDataset.py clouds have this; our uniform synthetic
    clouds do not). Synthesized as:

    - `ground_fraction` ground returns: log-uniform range (density ~ 1/r
      along the ground ring, ~1/r^2 per area), uniform azimuth, small
      vertical jitter;
    - the rest in `num_clusters` vertical structures (walls/cars) at
      log-uniform ranges with tight Gaussian spread.

    Every length constant scales with `max_range` (min_range defaults to
    max_range/20, a 20:1 range ratio), so the density-gradient shape is
    preserved at any cloud scale — an earlier version had absolute
    constants that degenerated at max_range <= 1 (review finding).

    Returns [num_points, 3] float64, roughly centered at the origin.
    """
    if min_range is None:
        min_range = max_range / 20.0
    if not 0 < min_range < max_range:
        raise ValueError(f"need 0 < min_range < max_range, got "
                         f"{min_range}, {max_range}")
    scale = max_range
    n_ground = int(num_points * ground_fraction)
    n_struct = num_points - n_ground
    # ground ring
    r = np.exp(rng.uniform(np.log(min_range), np.log(max_range), n_ground))
    az = rng.uniform(0.0, 2.0 * np.pi, n_ground)
    ground = np.stack(
        [r * np.cos(az), r * np.sin(az),
         rng.normal(0.0, 0.005 * scale, n_ground)],
        axis=-1,
    )
    # vertical structures
    centers_r = np.exp(
        rng.uniform(np.log(min_range * 2), np.log(max_range), num_clusters)
    )
    centers_az = rng.uniform(0.0, 2.0 * np.pi, num_clusters)
    centers = np.stack(
        [
            centers_r * np.cos(centers_az),
            centers_r * np.sin(centers_az),
            rng.uniform(0.0, 0.15 * scale, num_clusters),
        ],
        axis=-1,
    )
    which = rng.integers(0, num_clusters, n_struct)
    spread = rng.normal(0.0, 0.04 * scale, (n_struct, 3))
    struct = centers[which] + spread
    return np.concatenate([ground, struct], axis=0)


class LidarLikeDataset(SyntheticDataset):
    """Synthetic velodyne-like clouds (radial density gradient) — the
    robustness set for the windowed/banded engines' occupancy assumptions
    and the second training distribution of the accuracy campaign."""

    def __init__(
        self,
        num_clouds: int = 64,
        num_points: int = 10000,
        max_range: float = 10.0,
        max_translation: float = 1.0,
        max_rotation_deg: Optional[float] = None,
        noise_std: float = 0.0,
        seed: int = 0,
    ):
        rng = np.random.default_rng(seed)
        self.clouds = [
            lidar_like_cloud(rng, num_points, max_range=max_range)
            for _ in range(num_clouds)
        ]
        self.normals = None
        self.max_translation = max_translation
        self.max_rotation_deg = max_rotation_deg
        self.noise_std = noise_std


def batch_iterator(
    dataset,
    batch_size: int,
    epoch: int = 0,
    seed: int = 0,
    shuffle: bool = True,
    drop_remainder: bool = True,
    host_id: int = 0,
    num_hosts: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (src [B,N,C], tgt [B,N,C], R [B,3,3], t [B,3]) numpy batches.

    Augmentation is seeded per (seed, epoch, index) so any pair can be
    reproduced independently of iteration order. With num_hosts > 1 each
    host reads a disjoint stride of the index stream (multi-host data
    parallelism; the reference's DataParallel has no multi-host analogue).
    """
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng((seed, epoch)).shuffle(order)
    order = order[host_id::num_hosts]
    limit = (
        len(order) - len(order) % batch_size if drop_remainder else len(order)
    )
    for start in range(0, limit, batch_size):
        idx = order[start : start + batch_size]
        pairs = [
            dataset.sample(int(i), np.random.default_rng((seed, epoch, int(i))))
            for i in idx
        ]
        yield (
            np.stack([p.src for p in pairs]),
            np.stack([p.tgt for p in pairs]),
            np.stack([p.R for p in pairs]),
            np.stack([p.t for p in pairs]),
        )
