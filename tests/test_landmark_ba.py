"""Landmark bundle adjustment with Schur complement
(odometry/pose_graph.py::optimize_landmark_ba): convergence to ground
truth, equivalence with a dense (Schur-free) Gauss-Newton oracle, and
sharded == unsharded on the 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np

from deepvcp.odometry import chain_poses, exp_so3
from deepvcp.odometry.pose_graph import (
    LandmarkObs,
    build_graph,
    optimize_landmark_ba,
)
from deepvcp.parallel import make_mesh
from deepvcp.utils import rotation_geodesic_deg


def _scene(rng, F=6, L=40, obs_noise=0.005):
    """Smooth trajectory + landmark field + frame-local observations."""
    R_abs = [np.eye(3)]
    t_abs = [np.zeros(3)]
    for _ in range(F - 1):
        dw = rng.uniform(-0.08, 0.08, 3)
        R_abs.append(R_abs[-1] @ np.asarray(exp_so3(jnp.asarray(dw[None]))[0]))
        t_abs.append(t_abs[-1] + rng.uniform(-0.5, 0.5, 3))
    R_abs, t_abs = np.stack(R_abs), np.stack(t_abs)
    lms = rng.uniform(-5, 5, (L, 3))
    # every frame observes every landmark (dense visibility)
    frame = np.repeat(np.arange(F), L).astype(np.int32)
    lm = np.tile(np.arange(L), F).astype(np.int32)
    obs_xyz = np.einsum(
        "oba,ob->oa", R_abs[frame], lms[lm] - t_abs[frame]
    ) + rng.normal(0, obs_noise, (F * L, 3))
    obs = LandmarkObs(
        frame=jnp.asarray(frame),
        lm=jnp.asarray(lm),
        xyz=jnp.asarray(obs_xyz, jnp.float32),
        weights=jnp.ones((F * L,), jnp.float32),
    )
    return R_abs, t_abs, lms, obs


def _perturb(rng, R_abs, t_abs, lms, rot=0.05, trans=0.15, lm_noise=0.1):
    F = R_abs.shape[0]
    dw = rng.normal(0, rot, (F, 3))
    dw[0] = 0.0  # keep the gauge frame exact
    dt = rng.normal(0, trans, (F, 3))
    dt[0] = 0.0
    R0 = jnp.asarray(
        np.einsum("fab,fbc->fac", R_abs,
                  np.asarray(exp_so3(jnp.asarray(dw)))), jnp.float32)
    t0 = jnp.asarray(t_abs + dt, jnp.float32)
    lm0 = jnp.asarray(lms + rng.normal(0, lm_noise, lms.shape), jnp.float32)
    return R0, t0, lm0


def test_converges_to_ground_truth():
    rng = np.random.default_rng(0)
    R_abs, t_abs, lms, obs = _scene(rng)
    R0, t0, lm0 = _perturb(rng, R_abs, t_abs, lms)
    rre0 = float(jnp.mean(rotation_geodesic_deg(
        R0, jnp.asarray(R_abs, jnp.float32))))
    te0 = float(jnp.mean(jnp.linalg.norm(
        t0 - jnp.asarray(t_abs, jnp.float32), axis=-1)))
    R1, t1, lm1 = optimize_landmark_ba(
        None, R0, t0, lm0, obs, num_iters=10)
    rre1 = float(jnp.mean(rotation_geodesic_deg(
        R1, jnp.asarray(R_abs, jnp.float32))))
    te1 = float(jnp.mean(jnp.linalg.norm(
        t1 - jnp.asarray(t_abs, jnp.float32), axis=-1)))
    lme1 = float(jnp.mean(jnp.linalg.norm(
        lm1 - jnp.asarray(lms, jnp.float32), axis=-1)))
    # 0.005 observation noise over dense visibility -> near-exact
    assert rre1 < 0.1 and rre1 < rre0 / 10, (rre0, rre1)
    assert te1 < 0.02 and te1 < te0 / 10, (te0, te1)
    assert lme1 < 0.02, lme1


def test_matches_dense_oracle_one_step():
    """One Schur GN step == one dense (joint-state) GN step."""
    rng = np.random.default_rng(1)
    R_abs, t_abs, lms, obs = _scene(rng, F=4, L=10)
    R0, t0, lm0 = _perturb(rng, R_abs, t_abs, lms)
    damping = 1e-3
    F, L = 4, 10

    R1, t1, lm1 = optimize_landmark_ba(
        None, R0, t0, lm0, obs, num_iters=1, damping=damping)

    # dense oracle: jacfwd over the full (pose, landmark) state
    def residual_vec(state):
        dpose, dlm = state
        dw = dpose[:, :3].at[0].set(0.0)
        dt = dpose[:, 3:].at[0].set(0.0)
        Rn = R0 @ exp_so3(dw)
        tn = t0 + dt
        ln = lm0 + dlm
        y = jnp.einsum("oba,ob->oa", Rn[obs.frame],
                       ln[obs.lm] - tn[obs.frame])
        return ((y - obs.xyz) * jnp.sqrt(obs.weights)[:, None]).reshape(-1)

    z = (jnp.zeros((F, 6)), jnp.zeros((L, 3)))
    Jp, Jl = jax.jacfwd(residual_vec)(z)
    J = jnp.concatenate(
        [Jp.reshape(-1, F * 6), Jl.reshape(-1, L * 3)], axis=-1)
    r = residual_vec(z)
    H = J.T @ J + damping * jnp.eye(F * 6 + L * 3)
    delta = -jnp.linalg.solve(H, J.T @ r)
    dpose = delta[: F * 6].reshape(F, 6)
    dw = dpose[:, :3].at[0].set(0.0)
    dt = dpose[:, 3:].at[0].set(0.0)
    R_or = R0 @ exp_so3(dw)
    t_or = t0 + dt
    lm_or = lm0 + delta[F * 6:].reshape(L, 3)

    assert float(jnp.max(rotation_geodesic_deg(R1, R_or))) < 0.05
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t_or), atol=2e-3)
    np.testing.assert_allclose(np.asarray(lm1), np.asarray(lm_or), atol=2e-3)


def test_sharded_matches_unsharded():
    rng = np.random.default_rng(2)
    R_abs, t_abs, lms, obs = _scene(rng)
    R0, t0, lm0 = _perturb(rng, R_abs, t_abs, lms)
    # include pose-graph edges so both term paths are exercised
    F = R_abs.shape[0]
    R_rel, t_rel = [], []
    for i in range(F - 1):
        R_rel.append(R_abs[i + 1].T @ R_abs[i])
        t_rel.append(R_abs[i + 1].T @ (t_abs[i] - t_abs[i + 1]))
    graph = build_graph(jnp.asarray(np.stack(R_rel), jnp.float32),
                        jnp.asarray(np.stack(t_rel), jnp.float32))

    R1, t1, lm1 = optimize_landmark_ba(
        graph, R0, t0, lm0, obs, num_iters=6)
    mesh = make_mesh(data=8, point=1)
    R2, t2, lm2 = optimize_landmark_ba(
        graph, R0, t0, lm0, obs, mesh=mesh, num_iters=6)
    assert float(jnp.max(rotation_geodesic_deg(R1, R2))) < 0.05
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), atol=2e-3)
    np.testing.assert_allclose(np.asarray(lm1), np.asarray(lm2), atol=2e-3)


def test_ba_improves_noisy_odometry_ate():
    """The odometry story: noisy chained relative poses diverge; adding
    landmark observations and running BA must cut the trajectory error
    vs the pose-only graph optimum."""
    from deepvcp.odometry import (
        absolute_trajectory_error,
        optimize_pose_graph,
    )

    rng = np.random.default_rng(3)
    R_abs, t_abs, lms, obs = _scene(rng, F=8, L=30)
    # noisy odometry chain
    R_rel, t_rel = [], []
    for i in range(R_abs.shape[0] - 1):
        Rn = np.asarray(exp_so3(jnp.asarray(rng.normal(0, 0.02, 3)[None]))[0])
        R_rel.append(R_abs[i + 1].T @ R_abs[i] @ Rn)
        t_rel.append(R_abs[i + 1].T @ (t_abs[i] - t_abs[i + 1])
                     + rng.normal(0, 0.05, 3))
    graph = build_graph(jnp.asarray(np.stack(R_rel), jnp.float32),
                        jnp.asarray(np.stack(t_rel), jnp.float32))
    R0, t0 = chain_poses(jnp.asarray(np.stack(R_rel), jnp.float32),
                         jnp.asarray(np.stack(t_rel), jnp.float32))
    t_true = jnp.asarray(t_abs, jnp.float32)

    Rp, tp = optimize_pose_graph(graph, R0, t0, num_iters=10)
    ate_pose_only = float(absolute_trajectory_error(tp, t_true))

    lm0 = jnp.asarray(lms + rng.normal(0, 0.1, lms.shape), jnp.float32)
    Rb, tb, _ = optimize_landmark_ba(graph, R0, t0, lm0, obs,
                                     num_iters=10)
    ate_ba = float(absolute_trajectory_error(tb, t_true))
    assert ate_ba < ate_pose_only * 0.5, (ate_pose_only, ate_ba)
