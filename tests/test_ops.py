"""Unit tests for the geometry kernel library against numpy oracles
(SURVEY.md §4: per-kernel tests vs numpy oracles)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepvcp import ops


def _rand(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


class TestSquareDistance:
    def test_matches_numpy(self):
        src = _rand((2, 17, 3), 1)
        dst = _rand((2, 23, 3), 2)
        got = np.asarray(ops.square_distance(jnp.asarray(src), jnp.asarray(dst)))
        want = np.sum((src[:, :, None, :] - dst[:, None, :, :]) ** 2, axis=-1)
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_nonnegative(self):
        x = _rand((1, 50, 3), 3, scale=100.0)
        d = np.asarray(ops.square_distance(jnp.asarray(x), jnp.asarray(x)))
        assert (d >= 0).all()


class TestIndexPoints:
    def test_2d_idx(self):
        pts = _rand((3, 10, 4), 4)
        idx = np.array([[0, 9, 3], [1, 1, 2], [5, 6, 7]], dtype=np.int32)
        got = np.asarray(ops.index_points(jnp.asarray(pts), jnp.asarray(idx)))
        for b in range(3):
            np.testing.assert_array_equal(got[b], pts[b, idx[b]])

    def test_3d_idx(self):
        pts = _rand((2, 8, 5), 5)
        rng = np.random.default_rng(6)
        idx = rng.integers(0, 8, size=(2, 4, 3)).astype(np.int32)
        got = np.asarray(ops.index_points(jnp.asarray(pts), jnp.asarray(idx)))
        assert got.shape == (2, 4, 3, 5)
        for b in range(2):
            np.testing.assert_array_equal(got[b], pts[b][idx[b]])


def _ball_query_oracle(radius, nsample, xyz, new_xyz):
    """Reference semantics (pointnet2_utils.py:87-107): lowest-index in-radius
    neighbors, pad with first hit."""
    B, S, _ = new_xyz.shape
    N = xyz.shape[1]
    out = np.zeros((B, S, nsample), dtype=np.int64)
    for b in range(B):
        d = np.sum((new_xyz[b][:, None, :] - xyz[b][None, :, :]) ** 2, -1)
        for s in range(S):
            hits = np.nonzero(d[s] <= radius**2)[0]
            if len(hits) == 0:
                out[b, s] = N - 1  # our clamp; reference crashes here
                continue
            sel = hits[:nsample]
            pad = np.full(nsample - len(sel), sel[0])
            out[b, s] = np.concatenate([sel, pad])
    return out


class TestQueryBallPoint:
    @pytest.mark.parametrize("chunk", [None, 7])
    def test_matches_oracle(self, chunk):
        xyz = _rand((2, 40, 3), 7)
        new_xyz = xyz[:, :13]
        got = np.asarray(
            ops.query_ball_point(0.8, 6, jnp.asarray(xyz), jnp.asarray(new_xyz), chunk=chunk)
        )
        want = _ball_query_oracle(0.8, 6, xyz, new_xyz)
        np.testing.assert_array_equal(got, want)

    def test_self_query_includes_self(self):
        # radius well above the f32 cancellation error of the matmul
        # expansion (~1e-6 on unit-scale data) but below inter-point spacing
        xyz = _rand((1, 20, 3), 8, scale=5.0)
        idx = np.asarray(ops.query_ball_point(1e-2, 4, jnp.asarray(xyz), jnp.asarray(xyz)))
        np.testing.assert_array_equal(idx[0, :, 0], np.arange(20))


class TestKNN:
    @pytest.mark.parametrize("chunk", [None, 5])
    def test_matches_oracle(self, chunk):
        ref = _rand((2, 30, 3), 9)
        query = _rand((2, 11, 3), 10)
        dist, idx = ops.knn(jnp.asarray(ref), jnp.asarray(query), k=4, chunk=chunk)
        dist, idx = np.asarray(dist), np.asarray(idx)
        d = np.sqrt(
            np.sum((query[:, :, None, :] - ref[:, None, :, :]) ** 2, -1)
        )
        want_idx = np.argsort(d, axis=-1, kind="stable")[..., :4]
        want_dist = np.take_along_axis(d, want_idx, axis=-1)
        np.testing.assert_allclose(dist, want_dist, atol=1e-3)
        # indices can differ under exact ties; compare distances per index
        got_d = np.take_along_axis(d, idx.astype(np.int64), axis=-1)
        np.testing.assert_allclose(got_d, want_dist, atol=1e-3)

    @pytest.mark.parametrize("chunk", [None, 16])
    def test_approx_knn_matches_exact(self, chunk):
        # On CPU and GPU approx_min_k lowers to an exact reduction, so
        # approx_knn must agree with the brute-force oracle.
        from deepvcp.ops.knn import approx_knn

        ref = _rand((2, 40, 3), 13)
        query = _rand((2, 21, 3), 14)
        dist, idx = approx_knn(
            jnp.asarray(ref), jnp.asarray(query), k=4, chunk=chunk
        )
        d = np.sqrt(
            np.sum((query[:, :, None, :] - ref[:, None, :, :]) ** 2, -1)
        )
        want_idx = np.argsort(d, axis=-1, kind="stable")[..., :4]
        want_dist = np.take_along_axis(d, want_idx, axis=-1)
        got_d = np.take_along_axis(
            d, np.asarray(idx).astype(np.int64), axis=-1
        )
        np.testing.assert_allclose(np.asarray(dist), want_dist, atol=1e-3)
        np.testing.assert_allclose(got_d, want_dist, atol=1e-3)

    def test_bf16_selection_survives_coordinate_offset(self):
        """Review finding: the old all-bf16 d^2 expansion lost tens of m^2
        to catastrophic cancellation at KITTI-scale absolute coordinates.
        The fixed path (center on the reference mean, f32 accumulation,
        f32 combine, cast only the final tile) must keep near-perfect
        selection overlap when the same cloud is shifted far from the
        origin."""
        from deepvcp.ops.knn import approx_knn, knn

        rng = np.random.default_rng(21)
        ref = rng.uniform(-10, 10, (1, 400, 3)).astype(np.float32)
        query = rng.uniform(-10, 10, (1, 100, 3)).astype(np.float32)
        k = 8

        def overlap(offset):
            r = jnp.asarray(ref + offset)
            q = jnp.asarray(query + offset)
            _, idx_exact = knn(r, q, k=k)
            _, idx_bf16 = approx_knn(r, q, k=k, select_dtype="bfloat16")
            a = np.asarray(idx_exact)
            b = np.asarray(idx_bf16)
            inter = [
                len(set(a[0, i]) & set(b[0, i])) for i in range(a.shape[1])
            ]
            return np.mean(inter) / k

        at_origin = overlap(0.0)
        far_away = overlap(1000.0)  # ~100 bf16-ulps of absolute coordinate
        assert at_origin >= 0.9, at_origin
        # centering makes selection translation-invariant up to ties
        assert far_away >= at_origin - 0.05, (far_away, at_origin)

    def test_nearest_neighbor_dist(self):
        ref = _rand((1, 25, 3), 11)
        query = _rand((1, 9, 3), 12)
        got = np.asarray(ops.nearest_neighbor_dist(jnp.asarray(ref), jnp.asarray(query)))
        d = np.sum((query[:, :, None, :] - ref[:, None, :, :]) ** 2, -1)
        np.testing.assert_allclose(got, d.min(-1), atol=1e-4)


class TestFPS:
    def test_first_is_start_and_unique(self):
        xyz = _rand((2, 50, 3), 13)
        idx = np.asarray(ops.farthest_point_sample(jnp.asarray(xyz), 10))
        assert (idx[:, 0] == 0).all()
        for b in range(2):
            assert len(set(idx[b].tolist())) == 10

    def test_matches_sequential_oracle(self):
        xyz = _rand((1, 30, 3), 14)
        npoint = 8
        got = np.asarray(ops.farthest_point_sample(jnp.asarray(xyz), npoint))[0]
        # oracle
        dist = np.full(30, np.inf)
        far = 0
        want = []
        for _ in range(npoint):
            want.append(far)
            d = np.sum((xyz[0] - xyz[0][far]) ** 2, -1)
            dist = np.minimum(dist, d)
            far = int(np.argmax(dist))
        np.testing.assert_array_equal(got, np.array(want))


class TestVoxelize:
    def test_grid_matches_reference_semantics(self):
        # ref voxelize.py:62-71: arange(c - r - s/2, c + r, s) per axis
        r, s = 1.0, 0.4
        offs = np.asarray(ops.candidate_offsets(r, s))
        assert offs.shape == (216, 3)
        ax = np.arange(-r - s / 2, r, s)
        want = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
        np.testing.assert_allclose(offs, want, atol=1e-6)

    def test_centered_grid_is_symmetric(self):
        # D12 fix: centered offsets have zero mean and mirror symmetry;
        # the reference grid (centered=False) averages to -s/2 per axis
        r, s = 1.0, 0.4
        offs = np.asarray(ops.candidate_offsets(r, s, centered=True))
        assert offs.shape == (216, 3)
        np.testing.assert_allclose(offs.mean(axis=0), 0.0, atol=1e-6)
        flipped = -offs
        got = set(map(tuple, np.round(offs, 5)))
        want = set(map(tuple, np.round(flipped, 5)))
        assert got == want
        ref = np.asarray(ops.candidate_offsets(r, s, centered=False))
        np.testing.assert_allclose(ref.mean(axis=0), -s / 2, atol=1e-6)

    def test_broadcast_add(self):
        pts = _rand((2, 5, 3), 15)
        out = np.asarray(ops.voxelize(jnp.asarray(pts), 1.0, 0.4))
        assert out.shape == (2, 5, 216, 3)
        np.testing.assert_allclose(
            out - pts[:, :, None, :],
            np.broadcast_to(np.asarray(ops.candidate_offsets(1.0, 0.4)), (2, 5, 216, 3)),
            atol=1e-6,
        )


class TestKabsch:
    def test_recovers_known_transform(self):
        rng = np.random.default_rng(16)
        from deepvcp.utils import random_rotation

        x = _rand((2, 40, 3), 17)
        R_true = np.stack([random_rotation(rng) for _ in range(2)]).astype(np.float32)
        t_true = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
        y = np.einsum("bab,bnb->bna", R_true, x) if False else None
        y = np.einsum("bij,bnj->bni", R_true, x) + t_true[:, None, :]
        R, t = ops.kabsch(jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(np.asarray(R), R_true, atol=1e-4)
        np.testing.assert_allclose(np.asarray(t), t_true, atol=1e-4)

    def test_proper_rotation_under_reflection_degeneracy(self):
        # planar + mirrored points would give det=-1 without the Z fix (D5)
        x = np.array([[[1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0.0]]], np.float32)
        y = x[:, :, [1, 0, 2]]  # mirror
        R, t = ops.kabsch(jnp.asarray(x), jnp.asarray(y))
        det = np.linalg.det(np.asarray(R))
        np.testing.assert_allclose(det, 1.0, atol=1e-4)

    def test_weighted(self):
        rng = np.random.default_rng(18)
        from deepvcp.utils import random_rotation

        x = _rand((1, 30, 3), 19)
        R_true = random_rotation(rng).astype(np.float32)[None]
        t_true = np.array([[0.3, -0.2, 0.5]], np.float32)
        y = np.einsum("bij,bnj->bni", R_true, x) + t_true[:, None, :]
        # corrupt points that get zero weight
        y_bad = y.copy()
        y_bad[:, :5] += 10.0
        w = np.ones((1, 30), np.float32)
        w[:, :5] = 0.0
        R, t = ops.kabsch(jnp.asarray(x), jnp.asarray(y_bad), jnp.asarray(w))
        np.testing.assert_allclose(np.asarray(R), R_true, atol=1e-4)
        np.testing.assert_allclose(np.asarray(t), t_true, atol=1e-4)

    def test_differentiable(self):
        x = jnp.asarray(_rand((1, 10, 3), 20))
        y = jnp.asarray(_rand((1, 10, 3), 21))

        def f(y_):
            R, t = ops.kabsch(x, y_)
            return jnp.sum(R) + jnp.sum(t)

        g = jax.grad(f)(y)
        assert np.isfinite(np.asarray(g)).all()


class TestApplyRigid:
    def test_roundtrip(self):
        rng = np.random.default_rng(22)
        from deepvcp.utils import random_rotation

        x = jnp.asarray(_rand((2, 12, 3), 23))
        R = jnp.asarray(np.stack([random_rotation(rng) for _ in range(2)]).astype(np.float32))
        t = jnp.asarray(rng.uniform(-1, 1, (2, 3)).astype(np.float32))
        y = ops.apply_rigid(x, R, t)
        R_inv = jnp.swapaxes(R, -1, -2)
        x_back = ops.apply_rigid(y - t[:, None, :], R_inv, jnp.zeros_like(t))
        np.testing.assert_allclose(np.asarray(x_back), np.asarray(x), atol=1e-5)
