"""Golden parity tests against the actual PyTorch reference
(vccheng2001/DeepVCP-Pointcloud-Registration, mounted read-only at
/root/reference), per SURVEY.md §4: pinned inputs through both
implementations.

These import the reference's torch code at test time (never copied into
this repo) and are skipped wherever the reference checkout or torch is
unavailable. Modules that import knn_cuda (deepVCP_loss, get_cat_feat_tgt)
cannot load without a CUDA extension; the capabilities they cover are
parity-tested against our native C++ oracle instead (test_native.py).
"""

import sys

import numpy as np
import pytest

REF = "/root/reference"

torch = pytest.importorskip("torch")
pytestmark = pytest.mark.skipif(
    not __import__("os").path.isdir(REF), reason="reference not mounted"
)

if REF not in sys.path:
    sys.path.insert(0, REF)


@pytest.fixture(scope="module")
def ref_pn2():
    import pointnet2_utils  # the reference module

    return pointnet2_utils


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


class TestSquareDistance:
    def test_parity(self, ref_pn2):
        import jax.numpy as jnp

        from deepvcp import ops

        src = _rand((2, 33, 3), 0)
        dst = _rand((2, 21, 3), 1)
        ref = ref_pn2.square_distance(
            torch.from_numpy(src), torch.from_numpy(dst)
        ).numpy()
        ours = np.asarray(ops.square_distance(jnp.asarray(src), jnp.asarray(dst)))
        np.testing.assert_allclose(ours, ref, atol=1e-4)


class TestIndexPoints:
    def test_parity(self, ref_pn2):
        import jax.numpy as jnp

        from deepvcp import ops

        pts = _rand((2, 40, 5), 2)
        rng = np.random.default_rng(3)
        idx = rng.integers(0, 40, (2, 7)).astype(np.int64)
        ref = ref_pn2.index_points(
            torch.from_numpy(pts), torch.from_numpy(idx)
        ).numpy()
        ours = np.asarray(
            ops.index_points(jnp.asarray(pts), jnp.asarray(idx.astype(np.int32)))
        )
        np.testing.assert_allclose(ours, ref, atol=1e-6)


class TestFPS:
    def test_parity_with_pinned_start(self, ref_pn2, monkeypatch):
        """The reference starts from torch.randint; pin it to 0 to compare
        the deterministic trajectories."""
        import jax.numpy as jnp

        from deepvcp import ops

        xyz = _rand((2, 50, 3), 4)
        monkeypatch.setattr(
            torch,
            "randint",
            lambda low, high, size, **kw: torch.zeros(size, dtype=torch.long),
        )
        ref = ref_pn2.farthest_point_sample(torch.from_numpy(xyz), 12).numpy()
        ours = np.asarray(
            ops.farthest_point_sample(jnp.asarray(xyz), 12, start_idx=0)
        )
        np.testing.assert_array_equal(ours, ref)


class TestQueryBallPoint:
    def test_parity(self, ref_pn2):
        import jax.numpy as jnp

        from deepvcp import ops

        xyz = _rand((2, 60, 3), 5)
        new_xyz = xyz[:, :14]
        ref = ref_pn2.query_ball_point(
            0.9, 8, torch.from_numpy(xyz), torch.from_numpy(new_xyz)
        ).numpy()
        ours = np.asarray(
            ops.query_ball_point(0.9, 8, jnp.asarray(xyz), jnp.asarray(new_xyz))
        )
        np.testing.assert_array_equal(ours, ref)


class TestVoxelize:
    def test_parity(self):
        import jax.numpy as jnp

        import voxelize as ref_vox  # reference module

        from deepvcp import ops

        pts = _rand((1, 6, 3), 6, scale=3.0)
        ref = ref_vox.voxelize(torch.from_numpy(pts.copy()), 1.0, 0.4).numpy()
        ours = np.asarray(ops.voxelize(jnp.asarray(pts), 1.0, 0.4))
        assert ours.shape == ref.shape == (1, 6, 216, 3)
        np.testing.assert_allclose(ours, ref, atol=1e-5)


class TestRotations:
    def test_parity(self):
        import utils as ref_utils  # reference module

        from deepvcp.utils import rot_x, rot_y, rot_z

        for theta in (0.3, -1.2, 2.9):
            np.testing.assert_allclose(
                rot_x(theta), np.asarray(ref_utils.RotX(theta)), atol=1e-12
            )
            np.testing.assert_allclose(
                rot_y(theta), np.asarray(ref_utils.RotY(theta)), atol=1e-12
            )
            np.testing.assert_allclose(
                rot_z(theta), np.asarray(ref_utils.RotZ(theta)), atol=1e-12
            )


class TestCPG:
    def test_parity_with_transplanted_weights(self):
        """Run the reference cpg module and our CPG with the SAME conv
        weights (transposed to our [kd,kh,kw,in,out] layout) on the same cost-volume inputs."""
        import jax
        import jax.numpy as jnp

        import cpg as ref_cpg  # reference module

        from deepvcp.models.layers import CPG

        torch.manual_seed(0)
        net = ref_cpg.cpg()
        net.eval()
        B, N, C, F = 1, 4, 216, 32
        src = _rand((B, N, 1, F), 7)
        # intended cost-volume layout: per-candidate descriptors [B,N,C,F]
        tgt_intended = _rand((B, N, C, F), 8)
        cand = _rand((B, N, C, 3), 9)
        # Reference defect D11: cpg.py:34 reshapes its [B,N,32,C] input
        # straight to the (gs,gs,gs,32) grid without a permute, scrambling
        # feature/candidate axes. Feed it a pure memory VIEW of the
        # intended [B,N,C,F] tensor so its reshape reconstructs the
        # intended volume — this tests the conv/softmax/centroid machinery,
        # not the scramble.
        tgt_ref_view = tgt_intended.reshape(B, N, F, C)
        with torch.no_grad():
            ref_out = net(
                torch.from_numpy(src),
                torch.from_numpy(tgt_ref_view),
                torch.from_numpy(cand),
                1.0,
                0.4,
            ).numpy()

        ours = CPG(channels=(16, 4, 1), grid_size=6)
        vars_ = ours.init(
            jax.random.key(0),
            jnp.asarray(src[:, :, 0, :]),
            jnp.asarray(tgt_intended),
            jnp.asarray(cand),
        )
        # transplant torch Conv3d weights [out,in,kd,kh,kw] ->
        # [kd,kh,kw,in,out]
        params = vars_["params"]
        for i, name in enumerate(["Conv_0", "Conv_1", "Conv_2"]):
            w = getattr(net, f"conv{i+1}").weight.detach().numpy()
            b = getattr(net, f"conv{i+1}").bias.detach().numpy()
            params[name]["kernel"] = jnp.asarray(
                np.transpose(w, (2, 3, 4, 1, 0))
            )
            params[name]["bias"] = jnp.asarray(b)
        vcp, _ = ours.apply(
            {"params": params},
            jnp.asarray(src[:, :, 0, :]),
            jnp.asarray(tgt_intended),
            jnp.asarray(cand),
        )
        np.testing.assert_allclose(np.asarray(vcp), ref_out, atol=1e-4)
