"""Native host runtime: builds, binds, and matches the numpy/jnp oracles."""

import numpy as np
import pytest

from deepvcp import native


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.available(), "native library failed to build"


class TestVelodyneIO:
    def test_load_downsample(self, tmp_path):
        rng = np.random.default_rng(0)
        scan = rng.uniform(-20, 20, (500, 4)).astype(np.float32)
        path = str(tmp_path / "000000.bin")
        scan.tofile(path)
        out = native.velodyne_load_downsample(path, 256, seed=1)
        assert out.shape == (256, 3)
        # every sampled point is one of the original points
        d = np.abs(out[:, None, :] - scan[None, :, :3]).sum(-1).min(1)
        assert d.max() < 1e-6

    def test_upsample_short_scan(self, tmp_path):
        scan = np.arange(40, dtype=np.float32).reshape(10, 4)
        path = str(tmp_path / "short.bin")
        scan.tofile(path)
        out = native.velodyne_load_downsample(path, 32, seed=2)
        assert out.shape == (32, 3)


class TestKNNOracle:
    def test_matches_numpy(self):
        rng = np.random.default_rng(3)
        ref = rng.standard_normal((100, 3)).astype(np.float32)
        query = rng.standard_normal((17, 3)).astype(np.float32)
        dist, idx = native.knn(ref, query, 5)
        d = np.sqrt(np.sum((query[:, None] - ref[None]) ** 2, -1))
        want_idx = np.argsort(d, -1, kind="stable")[:, :5]
        want_d = np.take_along_axis(d, want_idx, -1)
        np.testing.assert_allclose(dist, want_d, atol=1e-5)
        got_d = np.take_along_axis(d, idx.astype(np.int64), -1)
        np.testing.assert_allclose(got_d, want_d, atol=1e-5)


class TestFPSOracle:
    def test_matches_jnp_kernel(self):
        import jax.numpy as jnp

        from deepvcp import ops

        rng = np.random.default_rng(4)
        xyz = rng.standard_normal((60, 3)).astype(np.float32)
        got = native.farthest_point_sample(xyz, 12)
        want = np.asarray(
            ops.farthest_point_sample(jnp.asarray(xyz[None]), 12)
        )[0]
        np.testing.assert_array_equal(got, want)


class TestBallQueryOracle:
    def test_matches_jnp_kernel(self):
        import jax.numpy as jnp

        from deepvcp import ops

        rng = np.random.default_rng(5)
        xyz = rng.standard_normal((50, 3)).astype(np.float32)
        got = native.query_ball_point(xyz, xyz[:13], 0.9, 6)
        want = np.asarray(
            ops.query_ball_point(
                0.9, 6, jnp.asarray(xyz[None]), jnp.asarray(xyz[None, :13])
            )
        )[0]
        np.testing.assert_array_equal(got, want)


class TestMakePair:
    def test_rigid_and_deterministic(self):
        rng = np.random.default_rng(6)
        src = rng.uniform(-2, 2, (80, 3)).astype(np.float32)
        tgt, R, t = native.make_pair(src, seed=7)
        np.testing.assert_allclose(tgt, src @ R.T + t, atol=1e-5)
        np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)
        tgt2, R2, t2 = native.make_pair(src, seed=7)
        np.testing.assert_array_equal(tgt, tgt2)


class TestNativeVsNumpyReaders:
    """Round-trip the SAME .bin through the native C++ reader and the
    numpy fallback (round-2 review: the two readers had never been
    compared on a file)."""

    def _write_scan(self, tmp_path, n=300, seed=0):
        rng = np.random.default_rng(seed)
        scan = rng.uniform(-50, 50, (n, 4)).astype(np.float32)
        path = str(tmp_path / "scan.bin")
        scan.tofile(path)
        return path, scan

    def test_raw_read_byte_for_byte(self, tmp_path):
        from deepvcp.data.datasets import read_velodyne_bin

        path, scan = self._write_scan(tmp_path)
        got = native.velodyne_load(path)
        want = read_velodyne_bin(path)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(
            got.view(np.uint32), want.view(np.uint32)
        )
        np.testing.assert_array_equal(got, scan)

    def test_downsample_same_point_set_when_n_equals_total(self, tmp_path):
        """At n == total both paths must return the full point set (the
        native path may permute; compare sorted rows bitwise)."""
        from deepvcp.data.datasets import read_velodyne_bin

        path, scan = self._write_scan(tmp_path, n=200, seed=1)
        got = native.velodyne_load_downsample(path, 200, seed=3)
        want = read_velodyne_bin(path)[:, :3]

        def canon(a):
            a = np.ascontiguousarray(a.astype(np.float32))
            v = a.view([("x", np.uint32), ("y", np.uint32), ("z", np.uint32)])
            return np.sort(v, order=("x", "y", "z"), axis=0)

        np.testing.assert_array_equal(canon(got), canon(want))
