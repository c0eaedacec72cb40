"""Data pipeline + trainer smoke tests."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from deepvcp import DeepVCPConfig
from deepvcp.config import TrainConfig
from deepvcp.data import (
    KITTIDataset,
    ModelNet40Dataset,
    SyntheticDataset,
    batch_iterator,
    make_pair,
)
from deepvcp.train import Trainer


class TestTransforms:
    def test_pair_oracle(self):
        """tgt must be exactly R @ src + t — the self-supervised oracle."""
        rng = np.random.default_rng(0)
        pts = rng.uniform(-1, 1, (100, 3))
        src, tgt, R, t = make_pair(pts, np.random.default_rng(1))
        np.testing.assert_allclose(tgt, src @ R.T + t, atol=1e-5)

    def test_pair_with_normals(self):
        rng = np.random.default_rng(2)
        pts = rng.uniform(-1, 1, (50, 3))
        nrm = rng.standard_normal((50, 3))
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        src, tgt, R, t = make_pair(pts, np.random.default_rng(3), normals=nrm)
        assert src.shape == (50, 6) and tgt.shape == (50, 6)
        # normals rotate but do not translate (ref ModelNet40Dataset.py:85)
        np.testing.assert_allclose(tgt[:, 3:], nrm @ R.T, atol=1e-5)


class TestSyntheticDataset:
    def test_batches_and_determinism(self):
        ds = SyntheticDataset(num_clouds=8, num_points=64)
        b1 = list(batch_iterator(ds, 4, epoch=0, seed=7))
        b2 = list(batch_iterator(ds, 4, epoch=0, seed=7))
        assert len(b1) == 2
        src, tgt, R, t = b1[0]
        assert src.shape == (4, 64, 3) and R.shape == (4, 3, 3)
        np.testing.assert_array_equal(b1[0][0], b2[0][0])
        np.testing.assert_array_equal(b1[0][2], b2[0][2])

    def test_host_sharding_disjoint(self):
        ds = SyntheticDataset(num_clouds=16, num_points=32)
        a = list(batch_iterator(ds, 2, epoch=0, seed=0, host_id=0, num_hosts=2))
        b = list(batch_iterator(ds, 2, epoch=0, seed=0, host_id=1, num_hosts=2))
        # same total coverage, disjoint streams
        sa = {x.tobytes() for batch in a for x in batch[0]}
        sb = {x.tobytes() for batch in b for x in batch[0]}
        assert not (sa & sb)
        assert len(sa) == len(sb) == 8


class TestModelNetLoader:
    @pytest.fixture
    def fake_root(self, tmp_path):
        rng = np.random.default_rng(4)
        cats = ["chair", "table"]
        (tmp_path / "modelnet10_shape_names.txt").write_text("\n".join(cats))
        names = []
        for cat in cats:
            (tmp_path / cat).mkdir()
            for i in range(2):
                name = f"{cat}_{i:04d}"
                data = rng.uniform(-1, 1, (128, 6))
                np.savetxt(tmp_path / cat / f"{name}.txt", data, delimiter=",")
                names.append(name)
        (tmp_path / "modelnet10_train.txt").write_text("\n".join(names))
        return str(tmp_path)

    def test_load_and_sample(self, fake_root):
        ds = ModelNet40Dataset(fake_root, split="train", num_points=64)
        assert len(ds) == 4
        p = ds.sample(0, np.random.default_rng(5))
        assert p.src.shape == (64, 6)
        np.testing.assert_allclose(
            p.tgt[:, :3], p.src[:, :3] @ p.R.T + p.t, atol=1e-5
        )


class TestKITTILoader:
    @pytest.fixture
    def fake_root(self, tmp_path):
        rng = np.random.default_rng(6)
        for seq in ["00", "03"]:
            vdir = tmp_path / "sequences" / seq / "velodyne"
            vdir.mkdir(parents=True)
            for i in range(3):
                scan = rng.uniform(-20, 20, (500, 4)).astype(np.float32)
                scan.tofile(vdir / f"{i:06d}.bin")
        return str(tmp_path)

    def test_load_and_sample(self, fake_root):
        ds = KITTIDataset(fake_root, sequences=("00",), num_points=256)
        assert len(ds) == 3
        p = ds.sample(1, np.random.default_rng(7))
        assert p.src.shape == (256, 3)
        np.testing.assert_allclose(p.tgt, p.src @ p.R.T + p.t, atol=1e-4)


class TestTrainer:
    def test_smoke_train_and_checkpoint(self, tmp_path):
        """Two epochs on tiny synthetic data: loss finite, state advances,
        checkpoint round-trips."""
        model_cfg = DeepVCPConfig.tiny(num_points=64, use_normal=False)
        train_cfg = TrainConfig(
            num_epochs=2,
            batch_size=2,
            checkpoint_dir=str(tmp_path / "ckpt"),
            metrics_path=str(tmp_path / "metrics.jsonl"),
            log_every=1,
        )
        ds = SyntheticDataset(num_clouds=4, num_points=64, extent=2.0)
        trainer = Trainer(model_cfg, train_cfg)
        sample = next(batch_iterator(ds, 2, epoch=0, seed=0))
        trainer.setup(sample)

        step0 = int(trainer.state.step)
        avg = trainer.train_epoch(batch_iterator(ds, 2, epoch=0, seed=0), 0)
        assert np.isfinite(avg["loss"])
        assert int(trainer.state.step) == step0 + 2

        path = trainer.save_checkpoint("test")
        # mutate then restore
        import jax

        zeroed = jax.tree_util.tree_map(jnp.zeros_like, trainer.state.params)
        before = trainer.state.params
        trainer.state = trainer.state.replace(params=zeroed)
        trainer.load_checkpoint(path)
        restored = trainer.state.params

        def norm(t):
            return sum(
                float(jnp.sum(jnp.abs(x)))
                for x in jax.tree_util.tree_leaves(t)
            )

        assert norm(restored) == pytest.approx(norm(before), rel=1e-6)

        # architecture provenance (review finding): the D12-D14 flags are
        # shape-compatible, so a mismatched load restores without error —
        # the trainer must warn.
        import dataclasses
        import warnings as _warnings

        mismatched = Trainer(
            dataclasses.replace(model_cfg, centered_grid=False), train_cfg
        )
        mismatched.setup(sample)
        with pytest.warns(UserWarning, match="different forward semantics"):
            mismatched.load_checkpoint(path)
        # missing provenance (pre-provenance checkpoint) also warns
        import os

        os.remove(path + ".arch.json")
        with pytest.warns(UserWarning, match="no architecture provenance"):
            trainer.load_checkpoint(path)

        # eval runs and logs metrics
        out = trainer.evaluate(batch_iterator(ds, 2, epoch=1, seed=1), 0)
        assert np.isfinite(out["loss"])
        lines = [
            json.loads(l)
            for l in open(train_cfg.metrics_path)
            if l.strip()
        ]
        assert any(r["kind"] == "eval" for r in lines)


class TestResidualInit:
    """TrainConfig residual-mode warm starts (init_translation='gt' +
    jitter) — the training distribution Registrar refinement needs (the
    round-3 Q4 sweep measured DIVERGENCE, 20->54->78 deg over 3 iters,
    for a model trained only on exact GT inits)."""

    def test_parity_mode_is_exact(self):
        from deepvcp.train.trainer import _train_init_pose
        from deepvcp.config import TrainConfig

        rng = np.random.default_rng(0)
        R = jnp.asarray(rng.standard_normal((2, 3, 3)).astype(np.float32))
        t = jnp.asarray(rng.standard_normal((2, 3)).astype(np.float32))
        R_i, t_i = _train_init_pose(
            TrainConfig(), jnp.int32(7), R, t
        )
        np.testing.assert_array_equal(np.asarray(R_i), np.asarray(R))
        np.testing.assert_array_equal(np.asarray(t_i), 0.0)

    def test_jitter_bounds_and_determinism(self):
        from deepvcp.train.trainer import _train_init_pose
        from deepvcp.config import TrainConfig
        from deepvcp.utils import (
            random_rotation,
            rotation_geodesic_deg,
        )

        import jax

        cfg = TrainConfig(init_translation="gt", init_rot_jitter_deg=8.0,
                          init_trans_jitter=0.12)
        rng = np.random.default_rng(1)
        B = 4
        R = jnp.asarray(
            np.stack([random_rotation(rng) for _ in range(B)])
            .astype(np.float32)
        )
        t = jnp.asarray(rng.standard_normal((B, 3)).astype(np.float32))
        seen = []
        for step in (0, 1):
            R_i, t_i = jax.jit(
                lambda s: _train_init_pose(cfg, s, R, t)
            )(jnp.int32(step))
            dt = np.abs(np.asarray(t_i - t))
            assert dt.max() <= 0.12 + 1e-6 and dt.max() > 0
            ang = np.asarray(rotation_geodesic_deg(R_i, R))
            assert ang.max() <= 8.0 + 1e-3 and ang.max() > 0
            # proper rotations
            np.testing.assert_allclose(
                np.linalg.det(np.asarray(R_i)), 1.0, atol=1e-4
            )
            seen.append((np.asarray(R_i), np.asarray(t_i)))
        # per-step keys differ; same step reproduces
        assert not np.allclose(seen[0][1], seen[1][1])
        R_re, t_re = _train_init_pose(cfg, jnp.int32(0), R, t)
        np.testing.assert_allclose(np.asarray(t_re), seen[0][1], atol=1e-7)

    def test_bad_mode_raises(self):
        from deepvcp.train.trainer import _train_init_pose
        from deepvcp.config import TrainConfig

        R = jnp.eye(3)[None]
        t = jnp.zeros((1, 3))
        with pytest.raises(ValueError, match="init_translation"):
            _train_init_pose(
                TrainConfig(init_translation="truth"), jnp.int32(0), R, t
            )

    def test_residual_train_step_runs(self):
        """One train step in residual mode: finite loss, metrics sane."""
        model_cfg = DeepVCPConfig.tiny(num_points=64, use_normal=False)
        tcfg = TrainConfig(
            num_epochs=1, batch_size=2, init_translation="gt",
            init_rot_jitter_deg=5.0, init_trans_jitter=0.1,
            checkpoint_dir="/tmp/resid_ck",
            metrics_path="/tmp/resid_m.jsonl",
        )
        ds = SyntheticDataset(num_clouds=2, num_points=64, extent=2.0)
        tr = Trainer(model_cfg, tcfg)
        sample = next(batch_iterator(ds, 2, epoch=0, seed=0))
        tr.setup(sample)
        src, tgt, R, t = (jnp.asarray(a) for a in sample)
        state, m = tr._train_step(tr.state, src, tgt, R, t)
        assert np.isfinite(float(m["loss"]))
        # eval warm init follows the residual mode (R_gt, t_gt)
        em, _ = tr._eval_step(state, src, tgt, R, t)
        assert np.isfinite(float(em["loss"]))


class TestConfigValidation:
    def test_enum_string_fields_validated(self):
        """resolve() fails loudly on typo'd enum-strings (review finding:
        a bad dfe_src_neighbors silently selected the defective
        reference-parity branch)."""
        import dataclasses

        base = DeepVCPConfig.tiny(num_points=64, use_normal=False)
        base.resolve()  # valid defaults pass
        with pytest.raises(ValueError, match="dfe_src_neighbors"):
            dataclasses.replace(base, dfe_src_neighbors="Cloud").resolve()
        with pytest.raises(ValueError, match="neighbor_method"):
            dataclasses.replace(base, neighbor_method="window").resolve()
        with pytest.raises(ValueError, match="spatial_extent"):
            dataclasses.replace(
                base, neighbor_method="banded", spatial_extent=1.0
            ).resolve()

    def test_kitti_scale_preset(self):
        """The velodyne preset resolves, engages the f32 candidate-KNN
        selection gate (bf16 cancels at meter-scale coordinates), and
        keeps the reference's meter-scale grid reach."""
        cfg = DeepVCPConfig.kitti_scale()
        cfg.resolve()
        assert cfg.knn_select_dtype_effective is None  # f32 selection
        assert cfg.search_radius == 1.0 and cfg.voxel_len == 0.4
        # the ModelNet-scale default does use the bf16 selection tile
        assert DeepVCPConfig(
            num_points=10000, use_normal=False, spatial_extent=2.5
        ).knn_select_dtype_effective is not None


class TestRegistrar:
    def test_register_without_ground_truth(self):
        """The inference path must work with identity init and no GT."""
        from deepvcp.registration import Registrar
        from deepvcp.models import DeepVCP
        import jax

        cfg = DeepVCPConfig.tiny(num_points=64, use_normal=False)
        model = DeepVCP(cfg=cfg)
        ds = SyntheticDataset(num_clouds=2, num_points=64, extent=2.0)
        src, tgt, R, t = next(batch_iterator(ds, 2, epoch=0, seed=0))
        variables = model.init(
            jax.random.key(0),
            jnp.asarray(src), jnp.asarray(tgt),
            jnp.asarray(R), jnp.asarray(t),
        )
        reg = Registrar(cfg, variables)
        out = reg(jnp.asarray(src), jnp.asarray(tgt))
        assert out.R.shape == (2, 3, 3)
        assert out.t.shape == (2, 3)
        # proper rotations
        dets = np.linalg.det(np.asarray(out.R))
        np.testing.assert_allclose(dets, 1.0, atol=1e-4)

    def test_refine_iters_composes(self):
        """refine_iters=2 must run the model a second time warm-started
        with pass 1's pose: its output differs from pass 1 and stays a
        proper rigid transform. (Accuracy evidence lives in the training
        campaign; this pins the mechanics.)"""
        from deepvcp.registration import Registrar
        from deepvcp.models import DeepVCP
        import jax

        cfg = DeepVCPConfig.tiny(num_points=64, use_normal=False)
        model = DeepVCP(cfg=cfg)
        ds = SyntheticDataset(num_clouds=2, num_points=64, extent=2.0)
        src, tgt, R, t = next(batch_iterator(ds, 2, epoch=0, seed=3))
        variables = model.init(
            jax.random.key(0),
            jnp.asarray(src), jnp.asarray(tgt),
            jnp.asarray(R), jnp.asarray(t),
        )
        with pytest.raises(ValueError):
            Registrar(cfg, variables, refine_iters=0)
        # guard=False: the raw chaining semantics (the guard intentionally
        # breaks pass-2 == manual-chain equivalence by restarting from the
        # best-so-far pose; it has its own test below)
        reg1 = Registrar(cfg, variables, refine_iters=1, guard=False)
        reg2 = Registrar(cfg, variables, refine_iters=2, guard=False)
        out1 = reg1(jnp.asarray(src), jnp.asarray(tgt))
        out2 = reg2(jnp.asarray(src), jnp.asarray(tgt))
        np.testing.assert_allclose(
            np.linalg.det(np.asarray(out2.R)), 1.0, atol=1e-4
        )
        assert not np.allclose(np.asarray(out1.R), np.asarray(out2.R))
        # pass 2 == manually feeding pass 1's pose back as the init
        manual = reg1(
            jnp.asarray(src), jnp.asarray(tgt), out1.R, out1.t
        )
        np.testing.assert_allclose(
            np.asarray(out2.R), np.asarray(manual.R), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(out2.t), np.asarray(manual.t), atol=1e-5
        )

    def test_refinement_guard_non_worsening(self):
        """The guard (default on) must make iteration non-worsening in the
        GT-free alignment score: the returned pose realizes the row-wise
        minimum of RegistrationOutput.scores, including the caller's init
        (round-3 finding: unguarded refinement DIVERGED 20.6 -> 78 deg on
        a parity-trained model, artifacts/campaign_r3c Q4)."""
        from deepvcp.loss.registration import svd_refine
        from deepvcp.models import DeepVCP
        from deepvcp.ops import apply_rigid, square_distance
        from deepvcp.registration import Registrar
        import jax

        cfg = DeepVCPConfig.tiny(num_points=64, use_normal=False)
        model = DeepVCP(cfg=cfg)
        # small-motion pairs: the identity init is decent, so an untrained
        # model's solves are likely to be REJECTED by the guard
        ds = SyntheticDataset(
            num_clouds=2, num_points=64, extent=2.0,
            max_rotation_deg=5.0, max_translation=0.1,
        )
        src, tgt, R, t = next(batch_iterator(ds, 2, epoch=0, seed=7))
        src, tgt = jnp.asarray(src), jnp.asarray(tgt)
        variables = model.init(
            jax.random.key(0), src, tgt, jnp.asarray(R), jnp.asarray(t)
        )
        reg = Registrar(cfg, variables, refine_iters=3)
        out = reg(src, tgt)
        scores = np.asarray(out.scores)
        assert scores.shape == (2, 4)  # init + 3 iterations

        def score(Rm, tv):
            y = apply_rigid(out.keypoints, Rm, tv)
            d2 = jnp.min(square_distance(y, tgt[..., :3]), axis=-1)
            k_in = max(int(d2.shape[-1] * reg.inlier_ratio), 3)
            neg, _ = jax.lax.top_k(-d2, k_in)
            return np.asarray(
                jnp.sqrt(jnp.mean(jnp.maximum(-neg, 0.0), axis=-1))
            )

        # the returned pose realizes the best score seen (incl. the init)
        np.testing.assert_allclose(
            score(out.R, out.t), scores.min(axis=-1), rtol=1e-4, atol=1e-6
        )
        # ... and in particular never loses to the identity init
        eye = jnp.broadcast_to(jnp.eye(3, dtype=src.dtype), (2, 3, 3))
        assert (score(out.R, out.t)
                <= score(eye, jnp.zeros((2, 3), src.dtype)) + 1e-6).all()
        # monotonicity across refine_iters settings: more iterations can
        # only improve (or tie) the accepted score
        s_prev = None
        for iters in (1, 2, 3):
            o = Registrar(cfg, variables, refine_iters=iters)(src, tgt)
            s = score(o.R, o.t)
            if s_prev is not None:
                assert (s <= s_prev + 1e-6).all()
            s_prev = s

    def test_extent_mismatch_warns(self):
        """Feeding clouds far larger than cfg.spatial_extent must warn: the
        bf16-selection gate and window sizing key off the DECLARED extent,
        so a silent mismatch reintroduces the ranking error the gate exists
        to avoid (round-2 review finding)."""
        import warnings

        from deepvcp.registration import Registrar
        from deepvcp.models import DeepVCP
        import jax

        cfg = DeepVCPConfig.tiny(num_points=64, use_normal=False)
        model = DeepVCP(cfg=cfg)
        rng = np.random.default_rng(0)
        # cfg.tiny declares spatial_extent=4; feed a ~40-unit cloud
        src = jnp.asarray(rng.uniform(-20, 20, (1, 64, 3)).astype(np.float32))
        tgt = src
        variables = model.init(
            jax.random.key(0), src, tgt,
            jnp.eye(3, dtype=jnp.float32)[None], jnp.zeros((1, 3)),
        )
        reg = Registrar(cfg, variables)
        with pytest.warns(UserWarning, match="spatial_extent"):
            reg(src, tgt)
        # one-time: a second call must not warn again
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            reg(src, tgt)

    def test_stream_matches_per_call(self):
        """stream() must yield the same outputs, in order, as per-call
        registration (it only changes dispatch overlap)."""
        from deepvcp.registration import Registrar
        from deepvcp.models import DeepVCP
        import jax

        cfg = DeepVCPConfig.tiny(num_points=64, use_normal=False)
        model = DeepVCP(cfg=cfg)
        ds = SyntheticDataset(num_clouds=5, num_points=64, extent=2.0)
        batches = [
            (jnp.asarray(s), jnp.asarray(tg))
            for (s, tg, _, _) in batch_iterator(ds, 1, epoch=0, seed=0)
        ][:5]
        s0, t0 = batches[0]
        variables = model.init(
            jax.random.key(0), s0, t0,
            jnp.eye(3, dtype=jnp.float32)[None], jnp.zeros((1, 3)),
        )
        reg = Registrar(cfg, variables)
        streamed = list(reg.stream(iter(batches), depth=3))
        assert len(streamed) == 5
        for (s, tg), out in zip(batches, streamed):
            ref = reg(s, tg)
            np.testing.assert_allclose(
                np.asarray(out.R), np.asarray(ref.R), atol=1e-6
            )
            np.testing.assert_allclose(
                np.asarray(out.t), np.asarray(ref.t), atol=1e-6
            )


class TestSmallMotionPairs:
    def test_bounded_rotation(self):
        from deepvcp.data import SyntheticDataset
        from deepvcp.utils import rotation_geodesic_deg

        ds = SyntheticDataset(
            num_clouds=8, num_points=32, extent=2.0,
            max_rotation_deg=5.0, max_translation=0.3,
        )
        for i in range(8):
            p = ds.sample(i, np.random.default_rng(i))
            ang = float(
                rotation_geodesic_deg(
                    jnp.asarray(p.R), jnp.eye(3, dtype=jnp.float32)
                )
            )
            assert ang <= 5.0 + 1e-3, ang
            assert np.abs(p.t).max() <= 0.3 + 1e-6
            # pair consistency: tgt == R src + t
            np.testing.assert_allclose(
                p.tgt, p.src @ p.R.T + p.t, atol=1e-5
            )

    def test_lidar_like_dataset(self):
        from deepvcp.data import LidarLikeDataset

        ds = LidarLikeDataset(num_clouds=2, num_points=256, max_range=10.0)
        p = ds.sample(0, np.random.default_rng(0))
        assert p.src.shape == (256, 3)
        np.testing.assert_allclose(p.tgt, p.src @ p.R.T + p.t, atol=1e-4)


class TestGtFreeEval:
    def test_eval_logs_both_operating_points(self, tmp_path):
        """Trainer.evaluate must report warm-started AND identity-init
        (GT-free) RRE/RTE (round-2 review: eval warm-starting with R_gt
        overstated capability with nothing honest alongside)."""
        from deepvcp.data import SyntheticDataset, batch_iterator
        from deepvcp.train import Trainer

        cfg = DeepVCPConfig.tiny(num_points=64, use_normal=False)
        tcfg = TrainConfig(
            num_epochs=1, batch_size=2,
            metrics_path=str(tmp_path / "m.jsonl"),
            checkpoint_dir=str(tmp_path / "ck"),
        )
        tr = Trainer(cfg, tcfg)
        ds = SyntheticDataset(num_clouds=2, num_points=64, extent=2.0)
        sample = next(batch_iterator(ds, 2, epoch=0, seed=0))
        tr.setup(sample)
        out = tr.evaluate(batch_iterator(ds, 2, epoch=0, seed=0))
        for key in ("rre_deg", "rte", "gt_free_rre_deg", "gt_free_rte"):
            assert key in out and np.isfinite(out[key]), (key, out)


class TestKITTISplit:
    @pytest.fixture
    def multi_seq_root(self, tmp_path):
        rng = np.random.default_rng(9)
        for seq in ["00", "01", "02", "03"]:
            vdir = tmp_path / "sequences" / seq / "velodyne"
            vdir.mkdir(parents=True)
            for i in range(10):
                rng.uniform(-20, 20, (300, 4)).astype(np.float32).tofile(
                    vdir / f"{i:06d}.bin"
                )
        return str(tmp_path)

    def test_sequence_based_split(self, multi_seq_root):
        train = KITTIDataset(multi_seq_root, split="train", num_points=64)
        test = KITTIDataset(multi_seq_root, split="test", num_points=64)
        full = KITTIDataset(multi_seq_root, split="all", num_points=64)
        assert train.sequences == ("00", "01", "02")
        assert test.sequences == ("03",)
        assert len(train) == 30 and len(test) == 10 and len(full) == 40
        assert not (set(train.files) & set(test.files))
        assert set(train.files) | set(test.files) == set(full.files)

    def test_single_sequence_scan_split(self, multi_seq_root):
        train = KITTIDataset(
            multi_seq_root, sequences=("02",), split="train", num_points=64
        )
        test = KITTIDataset(
            multi_seq_root, sequences=("02",), split="test", num_points=64
        )
        assert len(train) == 8 and len(test) == 2
        assert not (set(train.files) & set(test.files))

    def test_bad_split_raises(self, multi_seq_root):
        with pytest.raises(ValueError):
            KITTIDataset(multi_seq_root, split="validation")


class TestFrozenBatchStats:
    def test_freeze_keeps_stats_and_trains_params(self):
        """freeze_batch_stats: params update, batch_stats bit-stable
        (the round-5 long-fine-tune drift fix)."""
        import dataclasses

        import jax

        model_cfg = DeepVCPConfig.tiny(num_points=64, use_normal=False)
        ds = SyntheticDataset(num_clouds=2, num_points=64, extent=1.0,
                              seed=0)
        sample = next(batch_iterator(ds, 2, epoch=0, seed=0))
        tcfg = TrainConfig(num_epochs=1, batch_size=2,
                           metrics_path=None,
                           freeze_batch_stats=True)
        tr = Trainer(model_cfg, tcfg)
        tr.setup(sample)
        stats_before = jax.tree_util.tree_map(
            lambda a: np.asarray(a).copy(), tr.state.batch_stats)
        params_before = jax.tree_util.tree_map(
            lambda a: np.asarray(a).copy(), tr.state.params)
        for batch in batch_iterator(ds, 2, epoch=0, seed=0):
            tr.train_epoch(iter([batch]), 0)
            break
        same_stats = jax.tree_util.tree_all(jax.tree_util.tree_map(
            lambda a, b: bool((np.asarray(a) == b).all()),
            tr.state.batch_stats, stats_before))
        changed_params = not jax.tree_util.tree_all(
            jax.tree_util.tree_map(
                lambda a, b: bool((np.asarray(a) == b).all()),
                tr.state.params, params_before))
        assert same_stats
        assert changed_params
