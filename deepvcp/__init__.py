"""deepvcp — a point-cloud registration / LiDAR-odometry engine on the GPU.

A from-scratch JAX/XLA/Pallas re-design of the DeepVCP pipeline
(Lu & Song et al., ICCV 2019) with the capability surface of the
reference PyTorch implementation (vccheng2001/DeepVCP-Pointcloud-Registration):

    register(src_cloud, tgt_cloud, init_pose) -> (R, t, keypoints, vcps)
    train(dataset, config) -> checkpoints + metrics

Everything is batched, jittable, differentiable end-to-end, and shardable
over a `jax.sharding.Mesh` (data parallel over frame pairs + point-axis
sharding of the heavy pairwise-distance work).

Layout:
    ops/       geometry kernel library (pairwise distance, ball query, FPS,
               KNN, voxel candidate grids, Kabsch) — jnp reference impls +
               Pallas (Triton) kernels for the hot paths
    models/    modules (models/nn.py): set abstraction, feature extraction,
               weighting, deep feature embedding, CPG, and the DeepVCP
               assembly
    loss/      two-pass weighted-SVD registration loss
    data/      ModelNet40 / KITTI / synthetic pipelines
    train/     training driver, checkpointing, metrics, CLI
    parallel/  mesh + sharding rules
    odometry/  chained pairwise registration + pose-graph optimization
    utils/     rotations, metrics, visualization export
"""

__version__ = "0.1.0"

from deepvcp.config import DeepVCPConfig  # noqa: F401
