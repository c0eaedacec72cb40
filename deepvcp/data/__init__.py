from deepvcp.data.datasets import (
    KITTIDataset,
    LidarLikeDataset,
    ModelNet40Dataset,
    RegistrationPair,
    SyntheticDataset,
    batch_iterator,
    lidar_like_cloud,
    read_velodyne_bin,
)
from deepvcp.data.transforms import make_pair, random_pose, resample

__all__ = [
    "ModelNet40Dataset",
    "KITTIDataset",
    "SyntheticDataset",
    "LidarLikeDataset",
    "RegistrationPair",
    "batch_iterator",
    "lidar_like_cloud",
    "read_velodyne_bin",
    "make_pair",
    "random_pose",
    "resample",
]
