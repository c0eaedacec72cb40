from deepvcp.odometry.pipeline import (
    load_kitti_poses,
    load_sequence_scans,
    register_sequence,
    run_odometry,
)
from deepvcp.odometry.pose_graph import (
    LandmarkObs,
    PoseGraph,
    absolute_trajectory_error,
    build_graph,
    chain_poses,
    exp_so3,
    hat,
    log_so3,
    optimize_landmark_ba,
    optimize_pose_graph,
    optimize_pose_graph_sharded,
    relative_pose_errors,
)

__all__ = [
    "chain_poses",
    "build_graph",
    "optimize_pose_graph",
    "optimize_pose_graph_sharded",
    "optimize_landmark_ba",
    "LandmarkObs",
    "absolute_trajectory_error",
    "relative_pose_errors",
    "PoseGraph",
    "hat",
    "exp_so3",
    "log_so3",
    "run_odometry",
    "register_sequence",
    "load_kitti_poses",
    "load_sequence_scans",
]
