"""Global SO(3) initializer (deepvcp/initializer.py): coarse
alignment must bring unrestricted-SO(3) pairs into the local refiner's
basin (round-4 verdict missing #3)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deepvcp.initializer import so3_global_init, super_fibonacci_rotations
from deepvcp.utils.rotations import rotation_geodesic_deg


def test_super_fibonacci_grid_is_rotations():
    R = np.asarray(super_fibonacci_rotations(64))
    eye = np.eye(3)
    for r in R:
        np.testing.assert_allclose(r @ r.T, eye, atol=1e-5)
        assert np.linalg.det(r) == pytest.approx(1.0, abs=1e-5)
    # covering sanity: max pairwise min-angle far below random
    from itertools import combinations
    angles = []
    for a, b in combinations(range(0, 64, 4), 2):
        angles.append(float(rotation_geodesic_deg(
            jnp.asarray(R[a])[None], jnp.asarray(R[b])[None])[0]))
    assert min(angles) > 5.0  # no near-duplicates


def test_full_so3_pairs_enter_basin():
    from deepvcp.data import SyntheticDataset, batch_iterator

    ds = SyntheticDataset(num_clouds=4, num_points=512, extent=1.0,
                          seed=102)  # full-SO(3) rotations by default
    src, tgt, R_gt, t_gt = (jnp.asarray(a) for a in
                            next(batch_iterator(ds, 4, epoch=0, seed=0)))
    init = so3_global_init(src, tgt, n_tgt=512)
    rre = np.asarray(rotation_geodesic_deg(init.R, R_gt))
    rte = np.asarray(jnp.linalg.norm(init.t - t_gt, axis=-1))
    # identity init on full SO(3) averages ~90-130 deg; the coarse
    # alignment must land inside the cascade basin (<10 deg)
    assert rre.mean() < 5.0, (rre, rte)
    assert (rre < 10.0).all(), rre
    assert rte.mean() < 0.1, rte


def test_deterministic():
    from deepvcp.data import SyntheticDataset, batch_iterator

    ds = SyntheticDataset(num_clouds=2, num_points=256, extent=1.0,
                          seed=103)
    src, tgt, _, _ = (jnp.asarray(a) for a in
                      next(batch_iterator(ds, 2, epoch=0, seed=0)))
    a = so3_global_init(src, tgt, n_rotations=128, n_src=64, n_tgt=256)
    b = so3_global_init(src, tgt, n_rotations=128, n_src=64, n_tgt=256)
    np.testing.assert_array_equal(np.asarray(a.R), np.asarray(b.R))


def test_sparse_target_coverage_regression():
    """Round-5 campaign W4 regression: at N >> n_tgt the target
    subsample's NN spacing must not swamp the rotation signal. N=4096
    with the default n_tgt cap must still land inside the basin (the
    old n_tgt=1024 default returned ~random rotations here)."""
    from deepvcp.data import SyntheticDataset, batch_iterator

    ds = SyntheticDataset(num_clouds=2, num_points=4096, extent=1.0,
                          seed=104, noise_std=0.01)
    src, tgt, R_gt, t_gt = (jnp.asarray(a) for a in
                            next(batch_iterator(ds, 2, epoch=0, seed=0)))
    init = so3_global_init(src, tgt, n_rotations=1024)
    rre = np.asarray(rotation_geodesic_deg(init.R, R_gt))
    assert (rre < 10.0).all(), rre


def test_dense_cloud_symmetry_twins_regression():
    """The W4 post-mortem distilled (see so3_global_init docstring):
    dense cloud + near-symmetric support. The ICP-all design must land
    every pair in the refiner's basin; the retired sweep-then-refine
    designs locked onto octahedral twins (~90-180 deg) on such pairs."""
    from deepvcp.data import SyntheticDataset, batch_iterator

    ds = SyntheticDataset(num_clouds=2, num_points=10000, extent=1.0,
                          seed=102, noise_std=0.01)
    src, tgt, R_gt, t_gt = (jnp.asarray(a) for a in
                            next(batch_iterator(ds, 2, epoch=0, seed=777,
                                                shuffle=False)))
    init = so3_global_init(src, tgt)
    rre = np.asarray(rotation_geodesic_deg(init.R, R_gt))
    assert (rre < 10.0).all(), rre
