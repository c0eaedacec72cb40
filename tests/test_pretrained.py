"""Pretrained-checkpoint registry (deepvcp/pretrained.py).

The reference ships no weights (README tells users to train from
scratch); this framework commits campaign checkpoints and exposes them
by name. These tests pin the registry contract: every entry restores,
carries its arch provenance into the config, and drives end to end."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from deepvcp import pretrained


def test_available_lists_all():
    names = pretrained.available()
    assert set(names) == set(pretrained.REGISTRY)
    assert all(isinstance(v, str) and v for v in names.values())


@pytest.mark.parametrize("name", sorted(pretrained.REGISTRY))
def test_registry_entry_loads(name):
    import jax

    try:
        cfg, variables = pretrained.load(name, num_points=256)
    except FileNotFoundError:
        pytest.skip(f"{name} checkpoint not present in this checkout")
    assert cfg.num_points == 256
    leaves = jax.tree_util.tree_leaves(variables["params"])
    assert leaves and all(np.isfinite(np.asarray(l)).all() for l in leaves)
    # provenance applied: the registry models were all trained with the
    # fixed D12-D14 defaults and topk keypoints
    assert cfg.centered_grid and cfg.derotate_tgt_neighborhoods
    assert cfg.keypoint_selection == "topk"
    if name in ("modelnet-fine", "lidar-fine"):
        assert (cfg.search_radius, cfg.voxel_len) == (0.6, 0.2)
    if name == "kitti25":
        assert cfg.knn_select_dtype_effective is None  # f32 gate


def test_unknown_name_raises():
    with pytest.raises(KeyError, match="available"):
        pretrained.load("no-such-model")


def test_registrar_end_to_end():
    from deepvcp.data import SyntheticDataset, batch_iterator
    from deepvcp.utils.rotations import rotation_geodesic_deg

    try:
        reg = pretrained.registrar("modelnet-fine", num_points=256,
                                   refine_iters=1)
    except FileNotFoundError:
        pytest.skip("modelnet-fine checkpoint not present")
    ds = SyntheticDataset(num_clouds=2, num_points=256, extent=1.0,
                          seed=100, max_rotation_deg=10.0,
                          max_translation=0.5)
    src, tgt, R, t = (jnp.asarray(a)
                      for a in next(batch_iterator(ds, 2, epoch=0, seed=0)))
    out = reg(src, tgt)
    rre = np.asarray(rotation_geodesic_deg(out.R, R))
    assert np.isfinite(rre).all()
    assert np.isfinite(np.asarray(out.t)).all()
    # the trained checkpoint must beat THIS pair set's identity init
    # (round-4 advisor finding: a fixed <=10-deg bound is also satisfied
    # by an identity-output model, so it verified nothing). Rotation can
    # draw near-identity pairs, so assert on the GT-free guard score
    # (col 0 = identity init) and the translation error, both of which
    # identity init provably loses on this max_translation=0.5 set.
    sc = np.asarray(out.scores)                 # [B, iters + 1]
    assert (sc[:, -1] < sc[:, 0] - 1e-4).all(), sc
    rte = np.asarray(jnp.linalg.norm(out.t - t, axis=-1))
    rte_identity = np.asarray(jnp.linalg.norm(t, axis=-1))
    assert rte.mean() < rte_identity.mean(), (rte, rte_identity)
    assert rre.mean() <= 10.0, rre


def test_cascade_end_to_end():
    from deepvcp.registration import CascadeRegistrar

    try:
        casc = pretrained.cascade("modelnet-cascade", num_points=256)
    except FileNotFoundError:
        pytest.skip("cascade stage checkpoints not present")
    assert isinstance(casc, CascadeRegistrar)
    # per-entry refine_iters: (2, 1) => score blocks of 3 + 2 columns
    from deepvcp.data import SyntheticDataset, batch_iterator

    ds = SyntheticDataset(num_clouds=2, num_points=256, extent=1.0,
                          seed=100, max_rotation_deg=10.0,
                          max_translation=0.5)
    src, tgt, R, t = (jnp.asarray(a)
                      for a in next(batch_iterator(ds, 2, epoch=0, seed=0)))
    out = casc(src, tgt)
    sc = np.asarray(out.scores)
    assert sc.shape == (2, 5)
    # non-worsening vs the identity init under the guard
    assert (sc.min(axis=1) <= sc[:, 0] + 1e-7).all()


def test_unknown_cascade_raises():
    with pytest.raises(KeyError, match="available"):
        pretrained.cascade("no-such-cascade")


def test_arch_provenance_sa_radii_and_unapplied_keys(tmp_path, monkeypatch):
    """sa_radii provenance must land in cfg.sa_layers; unknown
    fingerprint keys must warn loudly (round-4 advisor: this loader
    applies provenance silently, unlike Trainer.load_checkpoint)."""
    import json
    import shutil
    import warnings

    entry = pretrained.REGISTRY["modelnet-coarse"]
    src_path = os.path.join(pretrained._ROOT, entry["path"])
    if not os.path.exists(src_path + ".npz"):
        pytest.skip("checkpoint not present")
    ck = tmp_path / "final"
    shutil.copyfile(src_path + ".npz", str(ck) + ".npz")
    arch = json.load(open(src_path + ".arch.json"))
    arch["sa_radii"] = [0.11, 0.22, 0.44]
    arch["future_semantics_flag"] = True
    with open(str(ck) + ".arch.json", "w") as fh:
        json.dump(arch, fh)
    monkeypatch.setitem(
        pretrained.REGISTRY, "tmp-model",
        dict(entry, path=os.path.relpath(str(ck), pretrained._ROOT)))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        cfg, variables = pretrained.load("tmp-model", num_points=128)
    assert [l.radius for l in cfg.sa_layers] == [0.11, 0.22, 0.44]
    assert any("future_semantics_flag" in str(w.message) for w in rec)


def test_routed_registrar_routes_by_density():
    """Mixture-of-experts routing: the density statistic must pick the
    lidar expert for lidar-like clouds and the uniform expert for
    uniform clouds, end to end through the public surface."""
    from deepvcp.data import LidarLikeDataset, SyntheticDataset, \
        batch_iterator

    try:
        reg = pretrained.routed_registrar(num_points=512, refine_iters=1)
    except FileNotFoundError:
        pytest.skip("expert checkpoints not present")
    uni = SyntheticDataset(num_clouds=2, num_points=512, extent=1.0,
                           seed=100, max_rotation_deg=10.0,
                           max_translation=0.5)
    lid = LidarLikeDataset(num_clouds=2, num_points=512, max_range=1.0,
                           seed=101, max_rotation_deg=10.0,
                           max_translation=0.5)
    su, *_ = next(batch_iterator(uni, 2, epoch=0, seed=0))
    sl, *_ = next(batch_iterator(lid, 2, epoch=0, seed=0))
    cv_u = np.asarray(reg.route_statistic(jnp.asarray(su)))
    cv_l = np.asarray(reg.route_statistic(jnp.asarray(sl)))
    assert (cv_u < reg.threshold).all(), cv_u
    assert (cv_l > reg.threshold).all(), cv_l
    # and both route end-to-end with a non-worsening guard
    for ds in (uni, lid):
        srcb, tgtb, Rb, tb = next(batch_iterator(ds, 2, epoch=0, seed=0))
        out = reg(jnp.asarray(srcb), jnp.asarray(tgtb))
        sc = np.asarray(out.scores)
        assert (sc.min(axis=1) <= sc[:, 0] + 1e-7).all()
