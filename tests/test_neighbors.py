"""Tests for the spatially-sorted windowed neighbor engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepvcp import ops
from deepvcp.ops import neighbors as nb


def _rand(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


class TestSortCloud:
    def test_sorted_and_permutation(self):
        xyz = _rand((2, 50, 3), 1, scale=5.0)
        cloud = nb.sort_cloud(jnp.asarray(xyz))
        key = np.asarray(cloud.key)
        assert (np.diff(key, axis=-1) >= 0).all()
        # perm maps sorted -> original
        for b in range(2):
            np.testing.assert_allclose(
                np.asarray(cloud.xyz)[b], xyz[b][np.asarray(cloud.perm)[b]]
            )


class TestSearchsorted:
    def test_matches_numpy(self):
        rng = np.random.default_rng(2)
        vals = np.sort(rng.standard_normal((3, 40)), axis=-1).astype(np.float32)
        queries = rng.standard_normal((3, 17)).astype(np.float32)
        got = np.asarray(
            nb.searchsorted_batched(jnp.asarray(vals), jnp.asarray(queries))
        )
        for b in range(3):
            want = np.searchsorted(vals[b], queries[b], side="left")
            np.testing.assert_array_equal(got[b], want)

    def test_duplicates(self):
        vals = jnp.asarray([[0.0, 1.0, 1.0, 1.0, 2.0]])
        q = jnp.asarray([[1.0, 0.5, 3.0, -1.0]])
        got = np.asarray(nb.searchsorted_batched(vals, q))
        np.testing.assert_array_equal(got[0], [1, 1, 5, 0])


class TestSelectFirstK:
    def test_oracle(self):
        rng = np.random.default_rng(3)
        mask = rng.random((4, 33)) < 0.3
        pos, count = nb.select_first_k(jnp.asarray(mask), 5)
        pos, count = np.asarray(pos), np.asarray(count)
        for r in range(4):
            hits = np.nonzero(mask[r])[0]
            np.testing.assert_array_equal(count[r], len(hits))
            if len(hits) == 0:
                continue
            expect = list(hits[:5]) + [hits[0]] * max(0, 5 - len(hits))
            np.testing.assert_array_equal(pos[r], expect)


class TestWindowedBallQuery:
    def test_full_window_matches_dense(self):
        """With window == N, windowed ball query must equal the dense
        reference-semantics ball query (after mapping through perm)."""
        xyz = _rand((2, 64, 3), 4, scale=2.0)
        q = xyz[:, :20]
        radius, ns = 1.0, 8
        cloud = nb.sort_cloud(jnp.asarray(xyz))
        idx_sorted = nb.windowed_ball_query(
            cloud, jnp.asarray(q), radius, ns, window=64
        )
        # map to original indices
        idx_orig = np.take_along_axis(
            np.asarray(cloud.perm), np.asarray(idx_sorted).reshape(2, -1), -1
        ).reshape(2, 20, ns)
        # oracle: in-radius sets must match (selection order differs because
        # "first by sorted index" != "first by original index")
        d = np.sum((q[:, :, None] - xyz[:, None]) ** 2, -1)
        for b in range(2):
            for s in range(20):
                hits = set(np.nonzero(d[b, s] <= radius**2)[0][:64].tolist())
                got = set(idx_orig[b, s].tolist())
                assert got <= hits
                # all neighbors found when fewer than ns hits
                if len(hits) <= ns:
                    assert got == hits

    def test_narrow_window_still_in_radius(self):
        xyz = _rand((1, 256, 3), 5, scale=10.0)
        cloud = nb.sort_cloud(jnp.asarray(xyz))
        idx = nb.windowed_ball_query(cloud, cloud.xyz, 1.0, 4, window=128)
        gathered = np.take_along_axis(
            np.asarray(cloud.xyz), np.asarray(idx).reshape(1, -1, 1), 1
        ).reshape(1, 256, 4, 3)
        d = np.sum(
            (gathered - np.asarray(cloud.xyz)[:, :, None]) ** 2, -1
        )
        # each point is its own neighbor; all selected are within radius
        assert (d.min(-1) < 1e-9).all()
        assert (d <= 1.0 + 1e-5).all()


class TestWindowedKNN:
    def test_full_window_exact(self):
        xyz = _rand((2, 80, 3), 6, scale=3.0)
        q = _rand((2, 15, 3), 7, scale=3.0)
        cloud = nb.sort_cloud(jnp.asarray(xyz))
        dist, idx = nb.windowed_knn(cloud, jnp.asarray(q), k=5, window=80)
        d_exact, _ = ops.knn(jnp.asarray(xyz), jnp.asarray(q), k=5)
        np.testing.assert_allclose(
            np.asarray(dist), np.asarray(d_exact), atol=1e-4
        )

    def test_windowed_recall(self):
        """With a reasonable window on uniform data, windowed KNN recalls
        nearly all true neighbors."""
        rng = np.random.default_rng(8)
        xyz = rng.uniform(-10, 10, (1, 2048, 3)).astype(np.float32)
        q = rng.uniform(-10, 10, (1, 256, 3)).astype(np.float32)
        cloud = nb.sort_cloud(jnp.asarray(xyz))
        dist, idx = nb.windowed_knn(cloud, jnp.asarray(q), k=8, window=512)
        d_exact, _ = ops.knn(jnp.asarray(xyz), jnp.asarray(q), k=8)
        # compare distance profiles: windowed ~= exact for most entries
        close = np.isclose(
            np.asarray(dist), np.asarray(d_exact), atol=1e-3
        ).mean()
        assert close > 0.97, close


class TestWindowFor:
    def test_bounds(self):
        w = nb.window_for(10000, 0.1, 80.0)
        assert 128 <= w <= 10000 and w % 128 == 0
        assert nb.window_for(64, 1.0, 2.0) == 64


class TestDensityGradient:
    """Robustness on velodyne-like density-gradient clouds (real LiDAR has
    ~100x radial density variation; uniform-cloud tests can't catch
    windowed under-coverage — round-1/2 review finding)."""

    def _cloud(self, n=4096, seed=0):
        from deepvcp.data.datasets import lidar_like_cloud

        rng = np.random.default_rng(seed)
        return lidar_like_cloud(rng, n, max_range=10.0).astype(np.float32)

    def test_occupancy_audit_detects_gradient(self):
        """slab_occupancy_stats must report a density peak far above the
        uniform expectation on a lidar-like cloud."""
        xyz = self._cloud()
        N = xyz.shape[0]
        occ = nb.slab_occupancy_stats(xyz, radius=0.4)
        uniform_expected = N * 2 * 0.4 / 20.0
        assert occ["max"] > 3 * uniform_expected, occ

    def test_windowed_coverage_after_audit(self):
        """Sizing the window to the AUDITED max occupancy restores full
        in-radius coverage on the gradient cloud (the audit's suggested fix
        actually works)."""
        xyz = self._cloud(n=2048)[None]
        radius, ns = 0.4, 16
        occ = nb.slab_occupancy_stats(xyz[0], radius)
        window = min(-(-occ["max"] // 128) * 128, xyz.shape[1])
        cloud = nb.sort_cloud(jnp.asarray(xyz))
        idx, count = nb.windowed_ball_query(
            cloud, cloud.xyz, radius, ns, window, return_count=True
        )
        # oracle: dense ball query on sorted coords
        _, dense_count = ops.query_ball_point(
            radius, ns, cloud.xyz, cloud.xyz, return_count=True
        )
        np.testing.assert_array_equal(
            np.asarray(count) > 0, np.asarray(dense_count) > 0
        )
        # every selected neighbor is genuinely in radius
        nb_xyz = ops.index_points(cloud.xyz, idx)
        d = np.linalg.norm(
            np.asarray(nb_xyz) - np.asarray(cloud.xyz)[:, :, None], axis=-1
        )
        assert (d <= radius + 1e-5).all()

    def test_zero_hit_rows_masked_in_sa(self):
        """An SA stage fed a deliberately under-sized window must produce
        ZERO pooled features for zero-hit rows, not a far point's geometry
        (the round-1 pollution finding, now wired through return_count)."""
        from deepvcp.config import SALayerConfig
        from deepvcp.models.layers import SetAbstraction

        # deterministic zero-hit construction: a 900-point "wall" that
        # shares the query's sort-axis slab but sits 100 units away in y —
        # the 128-wide window fills with wall points, none in 3-D radius,
        # and the query point itself overflows past the window's end
        radius = 0.1
        window = 128
        rng = np.random.default_rng(5)
        wall = np.stack(
            [
                rng.uniform(-radius, -1e-4, 900),
                np.full(900, 100.0),
                np.zeros(900),
            ],
            axis=-1,
        )
        rest = rng.uniform(5, 10, (123, 3))
        probe = np.zeros((1, 3))
        xyz = np.concatenate([wall, probe, rest]).astype(np.float32)[None]
        cloud = nb.sort_cloud(jnp.asarray(xyz))
        idx, count = nb.windowed_ball_query(
            cloud, cloud.xyz, radius, 8, window, return_count=True
        )
        count = np.asarray(count)
        assert (count == 0).any(), "construction must produce zero-hit rows"
        layer = SALayerConfig(npoint=1024, radius=radius, nsample=8,
                              mlp=(8, 8))
        sa = SetAbstraction(layer, use_batchnorm=False, window=window)
        variables = sa.init(
            jax.random.key(0), cloud.xyz, None, False, cloud
        )
        _, pooled = sa.apply(
            variables, cloud.xyz, None, False, cloud
        )
        pooled = np.asarray(pooled)
        zero_rows = pooled[0][count[0] == 0]
        np.testing.assert_array_equal(zero_rows, 0.0)

    @pytest.mark.parametrize("method", ["dense", "windowed", "banded"])
    def test_model_forward_finite_on_gradient_cloud(self, method):
        """All three neighbor engines must produce finite outputs on the
        density-gradient cloud (garbage gathers masked, no NaN/inf)."""
        from deepvcp import DeepVCPConfig
        from deepvcp.models import DeepVCP

        n = 512
        xyz = self._cloud(n=n, seed=3)[None]
        cfg = DeepVCPConfig.tiny(num_points=n, use_normal=False)
        import dataclasses
        cfg = dataclasses.replace(
            cfg, neighbor_method=method, spatial_extent=20.0,
            knn_window=min(512, n),
        )
        model = DeepVCP(cfg=cfg)
        src = jnp.asarray(xyz)
        variables = model.init(
            jax.random.key(0), src, src,
            jnp.eye(3, dtype=jnp.float32)[None], jnp.zeros((1, 3)),
        )
        kp, vcp, aux = model.apply(
            variables, src, src,
            jnp.eye(3, dtype=jnp.float32)[None], jnp.zeros((1, 3)),
            train=False,
        )
        assert np.isfinite(np.asarray(kp)).all()
        assert np.isfinite(np.asarray(vcp)).all()
