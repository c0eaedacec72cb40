from deepvcp.utils.rotations import (
    euler_error_deg,
    euler_to_matrix,
    euler_xyz_deg,
    random_rotation,
    random_small_rotation,
    rot_x,
    rot_y,
    rot_z,
    rotation_geodesic_deg,
    translation_error,
)

__all__ = [
    "rot_x",
    "rot_y",
    "rot_z",
    "euler_to_matrix",
    "random_rotation",
    "random_small_rotation",
    "rotation_geodesic_deg",
    "translation_error",
    "euler_xyz_deg",
    "euler_error_deg",
]
