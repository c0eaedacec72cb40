"""MSG / FeaturePropagation stages, pc_normalize, group_all, profiling."""

import jax
import jax.numpy as jnp
import numpy as np

from deepvcp import ops
from deepvcp.models.extra_layers import FeaturePropagation, SetAbstractionMSG


def _rand(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return jnp.asarray((scale * rng.standard_normal(shape)).astype(np.float32))


class TestPcNormalize:
    def test_unit_sphere(self):
        pc = _rand((2, 50, 3), 1, scale=7.0)
        out = ops.pc_normalize(pc)
        norms = np.linalg.norm(np.asarray(out), axis=-1)
        np.testing.assert_allclose(norms.max(-1), 1.0, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(out).mean(-2), 0.0, atol=1e-6
        )


class TestGroupAll:
    def test_shapes(self):
        xyz = _rand((2, 30, 3), 2)
        feat = _rand((2, 30, 5), 3)
        new_xyz, grouped = ops.group_all(xyz, feat)
        assert new_xyz.shape == (2, 1, 3)
        assert grouped.shape == (2, 1, 30, 8)
        np.testing.assert_array_equal(np.asarray(new_xyz), 0.0)


class TestMSG:
    def test_forward_and_downsampling(self):
        xyz = _rand((2, 64, 3), 4)
        feat = _rand((2, 64, 6), 5)
        msg = SetAbstractionMSG(
            npoint=16,
            radius_list=(0.5, 1.0),
            nsample_list=(8, 16),
            mlp_list=((16, 16), (16, 32)),
        )
        vs = msg.init(jax.random.key(0), xyz, feat, train=False)
        new_xyz, out = msg.apply(vs, xyz, feat, train=False)
        assert new_xyz.shape == (2, 16, 3)
        assert out.shape == (2, 16, 16 + 32)
        assert np.isfinite(np.asarray(out)).all()


class TestFeaturePropagation:
    def test_interpolates_back_to_dense(self):
        dense = _rand((1, 40, 3), 6)
        sparse = dense[:, :10]
        feat_sparse = _rand((1, 10, 8), 7)
        fp = FeaturePropagation(mlp=(16, 8))
        vs = fp.init(
            jax.random.key(0), dense, sparse, None, feat_sparse, train=False
        )
        out = fp.apply(vs, dense, sparse, None, feat_sparse, train=False)
        assert out.shape == (1, 40, 8)
        assert np.isfinite(np.asarray(out)).all()

    def test_single_sparse_point_broadcast(self):
        dense = _rand((1, 20, 3), 8)
        sparse = dense[:, :1]
        feat_sparse = _rand((1, 1, 4), 9)
        fp = FeaturePropagation(mlp=(4,), use_batchnorm=False)
        vs = fp.init(
            jax.random.key(0), dense, sparse, None, feat_sparse, train=False
        )
        out = fp.apply(vs, dense, sparse, None, feat_sparse, train=False)
        assert out.shape == (1, 20, 4)


class TestProfiling:
    def test_stage_timer(self):
        from deepvcp.utils.profiling import StageTimer

        timer = StageTimer()
        x = _rand((64, 64), 10)
        y = timer.timeit("matmul", lambda: x @ x)
        with timer.stage("add", sync=None):
            _ = x + x
        rep = timer.report()
        assert "matmul" in rep and "add" in rep and "total" in rep
        assert timer.as_dict()["matmul"] >= 0
