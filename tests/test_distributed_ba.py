"""Distributed (edge-sharded, psum-reduced) pose-graph BA on the 8-device
CPU mesh: must match the dense single-device optimizer."""

import jax
import jax.numpy as jnp
import numpy as np

from deepvcp.odometry import (
    build_graph,
    chain_poses,
    exp_so3,
    optimize_pose_graph,
    optimize_pose_graph_sharded,
)
from deepvcp.parallel import make_mesh
from deepvcp.utils import rotation_geodesic_deg


def _trajectory(F, rng, noise=0.03):
    R_abs = [np.eye(3)]
    t_abs = [np.zeros(3)]
    for _ in range(F - 1):
        dw = rng.uniform(-0.1, 0.1, 3)
        R_abs.append(R_abs[-1] @ np.asarray(exp_so3(jnp.asarray(dw[None]))[0]))
        t_abs.append(t_abs[-1] + rng.uniform(-1, 1, 3))
    R_abs, t_abs = np.stack(R_abs), np.stack(t_abs)
    R_rel, t_rel = [], []
    for i in range(F - 1):
        Rn = np.asarray(
            exp_so3(jnp.asarray(rng.normal(0, noise, 3)[None]))[0]
        )
        R_rel.append(R_abs[i + 1].T @ R_abs[i] @ Rn)
        t_rel.append(
            R_abs[i + 1].T @ (t_abs[i] - t_abs[i + 1])
            + rng.normal(0, noise, 3)
        )
    return R_abs, t_abs, np.stack(R_rel), np.stack(t_rel)


def test_sharded_matches_dense():
    rng = np.random.default_rng(0)
    _, _, R_rel, t_rel = _trajectory(9, rng)
    graph = build_graph(
        jnp.asarray(R_rel, jnp.float32), jnp.asarray(t_rel, jnp.float32)
    )
    R0, t0 = chain_poses(
        jnp.asarray(R_rel, jnp.float32), jnp.asarray(t_rel, jnp.float32)
    )

    R_dense, t_dense = optimize_pose_graph(graph, R0, t0, num_iters=8)

    mesh = make_mesh(data=8, point=1)
    R_shard, t_shard = optimize_pose_graph_sharded(
        graph, R0, t0, mesh, num_iters=8
    )
    # same optimum up to f32 psum reduction-order noise, which compounds
    # through the GN iterations; 0.1 deg is far below the 1.7 deg edge noise
    ang = rotation_geodesic_deg(R_shard, R_dense)
    assert float(jnp.max(ang)) < 0.1, np.asarray(ang)
    np.testing.assert_allclose(
        np.asarray(t_shard), np.asarray(t_dense), atol=5e-3
    )


def test_sharded_handles_nondivisible_edges():
    """8 edges + 2 loop closures = 10 edges over 8 shards (padding path)."""
    rng = np.random.default_rng(1)
    R_abs, t_abs, R_rel, t_rel = _trajectory(9, rng)
    extra = []
    for k in (4, 8):
        extra.append(
            (0, k, R_abs[k].T @ R_abs[0], R_abs[k].T @ (t_abs[0] - t_abs[k]))
        )
    graph = build_graph(
        jnp.asarray(R_rel, jnp.float32),
        jnp.asarray(t_rel, jnp.float32),
        extra_edges=extra,
    )
    R0, t0 = chain_poses(
        jnp.asarray(R_rel, jnp.float32), jnp.asarray(t_rel, jnp.float32)
    )
    mesh = make_mesh(data=8, point=1)
    R_s, t_s = optimize_pose_graph_sharded(graph, R0, t0, mesh, num_iters=6)
    R_d, t_d = optimize_pose_graph(graph, R0, t0, num_iters=6)
    assert float(jnp.max(rotation_geodesic_deg(R_s, R_d))) < 0.1
    np.testing.assert_allclose(np.asarray(t_s), np.asarray(t_d), atol=5e-3)
