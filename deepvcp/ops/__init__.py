"""Geometry kernel library (L1 replacement for pointnet2_utils.py / voxelize.py
/ knn_cuda; see SURVEY.md §2.1, §2.5, §2.11)."""

from deepvcp.ops.distance import map_query_chunks, square_distance
from deepvcp.ops.grouping import (
    group_all,
    group_neighbors,
    index_points,
    pc_normalize,
    query_ball_point,
    sample_and_group,
)
from deepvcp.ops.kabsch import apply_rigid, kabsch
from deepvcp.ops.knn import knn, nearest_neighbor_dist
from deepvcp.ops.sampling import farthest_point_sample
from deepvcp.ops.voxelize import candidate_offsets, voxelize

__all__ = [
    "square_distance",
    "map_query_chunks",
    "index_points",
    "pc_normalize",
    "group_all",
    "query_ball_point",
    "group_neighbors",
    "sample_and_group",
    "kabsch",
    "apply_rigid",
    "knn",
    "nearest_neighbor_dist",
    "farthest_point_sample",
    "voxelize",
    "candidate_offsets",
]
