"""Odometry: SO(3) maps, pose chaining, pose-graph optimization, metrics."""

import jax.numpy as jnp
import numpy as np
import pytest

from deepvcp.odometry import (
    absolute_trajectory_error,
    build_graph,
    chain_poses,
    exp_so3,
    log_so3,
    optimize_pose_graph,
    relative_pose_errors,
)
from deepvcp.utils import random_rotation, rotation_geodesic_deg


class TestSO3:
    def test_exp_log_roundtrip(self):
        rng = np.random.default_rng(0)
        w = rng.uniform(-1.5, 1.5, (10, 3)).astype(np.float32)
        R = exp_so3(jnp.asarray(w))
        dets = np.linalg.det(np.asarray(R))
        np.testing.assert_allclose(dets, 1.0, atol=1e-5)
        w_back = np.asarray(log_so3(R))
        np.testing.assert_allclose(w_back, w, atol=1e-4)

    def test_small_angle(self):
        w = jnp.asarray([[1e-9, 0.0, 0.0]])
        R = exp_so3(w)
        np.testing.assert_allclose(np.asarray(R)[0], np.eye(3), atol=1e-6)
        assert np.isfinite(np.asarray(log_so3(R))).all()


def _random_trajectory(F, rng, step_scale=0.1):
    """Ground-truth absolute poses + exact relative measurements."""
    R_abs = [np.eye(3)]
    t_abs = [np.zeros(3)]
    for _ in range(F - 1):
        dw = rng.uniform(-step_scale, step_scale, 3)
        R_abs.append(R_abs[-1] @ np.asarray(exp_so3(jnp.asarray(dw[None]))[0]))
        t_abs.append(t_abs[-1] + rng.uniform(-1, 1, 3))
    R_abs, t_abs = np.stack(R_abs), np.stack(t_abs)
    # relative measurements: x_j = R_ij x_i + t_ij for j = i+1
    R_rel, t_rel = [], []
    for i in range(F - 1):
        R_ij = R_abs[i + 1].T @ R_abs[i]
        t_ij = R_abs[i + 1].T @ (t_abs[i] - t_abs[i + 1])
        R_rel.append(R_ij)
        t_rel.append(t_ij)
    return R_abs, t_abs, np.stack(R_rel), np.stack(t_rel)


class TestChainPoses:
    def test_exact_measurements_reproduce_trajectory(self):
        rng = np.random.default_rng(1)
        R_abs, t_abs, R_rel, t_rel = _random_trajectory(8, rng)
        R_got, t_got = chain_poses(
            jnp.asarray(R_rel, jnp.float32), jnp.asarray(t_rel, jnp.float32)
        )
        np.testing.assert_allclose(np.asarray(R_got), R_abs, atol=1e-4)
        np.testing.assert_allclose(np.asarray(t_got), t_abs, atol=1e-4)


class TestPoseGraph:
    def test_noisy_odometry_with_loop_closure_improves(self):
        rng = np.random.default_rng(2)
        F = 10
        R_abs, t_abs, R_rel, t_rel = _random_trajectory(F, rng)
        # corrupt odometry edges with noise
        R_rel_n = np.stack(
            [
                R_rel[i] @ np.asarray(
                    exp_so3(jnp.asarray(rng.normal(0, 0.02, 3)[None]))[0]
                )
                for i in range(F - 1)
            ]
        )
        t_rel_n = t_rel + rng.normal(0, 0.05, t_rel.shape)
        R_chain, t_chain = chain_poses(
            jnp.asarray(R_rel_n, jnp.float32), jnp.asarray(t_rel_n, jnp.float32)
        )
        # exact loop closure edges 0->k tie the drift down
        extra = []
        for k in (5, 9):
            R_0k = R_abs[k].T @ R_abs[0]
            t_0k = R_abs[k].T @ (t_abs[0] - t_abs[k])
            extra.append((0, k, R_0k, t_0k))
        graph = build_graph(
            jnp.asarray(R_rel_n, jnp.float32),
            jnp.asarray(t_rel_n, jnp.float32),
            extra_edges=extra,
        )
        R_opt, t_opt = optimize_pose_graph(
            graph, R_chain, t_chain, num_iters=15
        )
        ate_before = float(
            absolute_trajectory_error(t_chain, jnp.asarray(t_abs, jnp.float32), align=False)
        )
        ate_after = float(
            absolute_trajectory_error(t_opt, jnp.asarray(t_abs, jnp.float32), align=False)
        )
        assert np.isfinite(ate_after)
        assert ate_after < ate_before

    def test_perfect_graph_stays_put(self):
        rng = np.random.default_rng(3)
        R_abs, t_abs, R_rel, t_rel = _random_trajectory(6, rng)
        graph = build_graph(
            jnp.asarray(R_rel, jnp.float32), jnp.asarray(t_rel, jnp.float32)
        )
        R0 = jnp.asarray(R_abs, jnp.float32)
        t0 = jnp.asarray(t_abs, jnp.float32)
        R_opt, t_opt = optimize_pose_graph(graph, R0, t0, num_iters=5)
        err = rotation_geodesic_deg(R_opt, R0)
        assert float(jnp.max(err)) < 0.05
        np.testing.assert_allclose(np.asarray(t_opt), t_abs, atol=1e-2)


class TestMetrics:
    def test_ate_alignment_invariance(self):
        rng = np.random.default_rng(4)
        t_true = rng.uniform(-10, 10, (20, 3)).astype(np.float32)
        R = random_rotation(rng).astype(np.float32)
        t_pred = t_true @ R.T + np.array([5.0, -3.0, 2.0], np.float32)
        ate = float(
            absolute_trajectory_error(
                jnp.asarray(t_pred), jnp.asarray(t_true), align=True
            )
        )
        assert ate < 1e-3

    def test_rpe_zero_for_identical(self):
        rng = np.random.default_rng(5)
        R_abs, t_abs, _, _ = _random_trajectory(7, rng)
        ang, dt = relative_pose_errors(
            jnp.asarray(R_abs, jnp.float32), jnp.asarray(t_abs, jnp.float32),
            jnp.asarray(R_abs, jnp.float32), jnp.asarray(t_abs, jnp.float32),
        )
        assert float(jnp.max(ang)) < 1e-3
        assert float(jnp.max(dt)) < 1e-5


class TestWarmStartSequence:
    """register_sequence's constant-velocity warm start: the prior must be
    threaded frame-to-frame so only per-frame ACCELERATION has to fit in
    the candidate grid's reach, not the absolute motion (round-2 review:
    identity init caps usable inter-frame motion at grid reach ~1.2)."""

    class _FakeRegistrar:
        """Returns the exact pose iff the init is within `reach` of the
        true relative pose (mimicking the grid-reach constraint); identity
        otherwise. Records every init it receives."""

        def __init__(self, true_poses, reach):
            self.true_poses = true_poses  # list of (R [3,3], t [3])
            self.reach = reach
            self.calls = 0
            self.inits = []

        def __call__(self, src, tgt, R_init=None, t_init=None):
            from types import SimpleNamespace

            R_true, t_true = self.true_poses[self.calls]
            self.calls += 1
            R0 = (
                np.eye(3, dtype=np.float32)
                if R_init is None
                else np.asarray(R_init)[0]
            )
            t0 = (
                np.zeros(3, dtype=np.float32)
                if t_init is None
                else np.asarray(t_init)[0]
            )
            # residual displacement the grid must absorb (rotation error
            # folded into translation at unit lever arm)
            resid = np.linalg.norm(t_true - t0) + np.linalg.norm(
                R_true - R0
            )
            ok = resid <= self.reach
            R = R_true if ok else np.eye(3, dtype=np.float32)
            t = t_true if ok else np.zeros(3, dtype=np.float32)
            return SimpleNamespace(
                R=jnp.asarray(R[None]), t=jnp.asarray(t[None])
            )

        def stream(self, pairs, depth=4):
            for pair in pairs:
                yield self(*pair)

    def _accelerating_sequence(self, num_frames=8):
        """Per-frame translation grows 0.5, 0.7, ... 1.9 along +x: absolute
        motion exceeds reach=1.2 from frame 5 on, but frame-to-frame
        acceleration is 0.2."""
        poses = []
        for i in range(num_frames - 1):
            t = np.array([0.5 + 0.2 * i, 0.0, 0.0], dtype=np.float32)
            poses.append((np.eye(3, dtype=np.float32), t))
        return poses

    def test_warm_start_succeeds_where_identity_fails(self):
        from deepvcp.odometry.pipeline import register_sequence

        poses = self._accelerating_sequence()
        scans = np.zeros((len(poses) + 1, 16, 3), np.float32)
        reach = 1.2

        cold = self._FakeRegistrar(poses, reach)
        R_c, t_c = register_sequence(
            cold, scans, warm_start=False
        )
        # identity init fails once motion exceeds reach
        t_true = np.stack([p[1] for p in poses])
        cold_err = np.linalg.norm(t_c - t_true, axis=-1)
        assert (cold_err > 0.5).any(), cold_err

        warm = self._FakeRegistrar(poses, reach)
        R_w, t_w = register_sequence(warm, scans, warm_start=True)
        np.testing.assert_allclose(t_w, t_true, atol=1e-6)
        # and the inits actually threaded: call i>0 got pose i-1
        # (register_sequence passed R_init/t_init on every call after the
        # first implicit identity)
        assert warm.calls == len(poses)
