"""Model-level tests: shapes, determinism, differentiability, and the
self-supervised-pair oracle (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepvcp import DeepVCPConfig
from deepvcp.loss import deepvcp_loss
from deepvcp.models import DeepVCP
from deepvcp.utils import random_rotation


@pytest.fixture(scope="module")
def tiny_setup():
    cfg = DeepVCPConfig.tiny(num_points=96)
    model = DeepVCP(cfg=cfg)
    rng = np.random.default_rng(0)
    B, N = 2, cfg.num_points
    src = jnp.asarray(rng.uniform(-1, 1, (B, N, 6)).astype(np.float32))
    R = jnp.asarray(
        np.stack([random_rotation(rng) for _ in range(B)]).astype(np.float32)
    )
    t = jnp.asarray(rng.uniform(-1, 1, (B, 3)).astype(np.float32))
    variables = model.init(jax.random.key(0), src, src, R, t, train=False)
    return cfg, model, variables, src, R, t


class TestForward:
    def test_shapes(self, tiny_setup):
        cfg, model, variables, src, R, t = tiny_setup
        kp, vcp, aux = model.apply(variables, src, src, R, t, train=False)
        B = src.shape[0]
        assert kp.shape == (B, cfg.num_keypoints, 3)
        assert vcp.shape == (B, cfg.num_keypoints, 3)
        assert aux["saliency"].shape == (B, cfg.num_points)
        assert aux["candidate_weights"].shape == (
            B, cfg.num_keypoints, cfg.num_candidates,
        )
        assert np.isfinite(np.asarray(vcp)).all()

    def test_jit_and_deterministic(self, tiny_setup):
        cfg, model, variables, src, R, t = tiny_setup
        f = jax.jit(lambda v, a, b: model.apply(v, a, b, R, t, train=False))
        kp1, vcp1, _ = f(variables, src, src)
        kp2, vcp2, _ = f(variables, src, src)
        np.testing.assert_array_equal(np.asarray(vcp1), np.asarray(vcp2))

    def test_batch_consistency(self, tiny_setup):
        """Batched forward == per-sample forward (the reference's defect D1
        made this impossible; here it is a hard invariant)."""
        cfg, model, variables, src, R, t = tiny_setup
        kp, vcp, _ = model.apply(variables, src, src, R, t, train=False)
        for b in range(src.shape[0]):
            kp_b, vcp_b, _ = model.apply(
                variables, src[b : b + 1], src[b : b + 1],
                R[b : b + 1], t[b : b + 1], train=False,
            )
            np.testing.assert_allclose(
                np.asarray(vcp_b[0]), np.asarray(vcp[b]), atol=2e-5
            )

    def test_no_normals(self):
        cfg = DeepVCPConfig.tiny(num_points=64, use_normal=False)
        model = DeepVCP(cfg=cfg)
        rng = np.random.default_rng(1)
        src = jnp.asarray(rng.uniform(-1, 1, (1, 64, 3)).astype(np.float32))
        R = jnp.eye(3)[None]
        t = jnp.zeros((1, 3))
        variables = model.init(jax.random.key(0), src, src, R, t)
        kp, vcp, _ = model.apply(variables, src, src, R, t)
        assert vcp.shape == (1, cfg.num_keypoints, 3)

    def test_vcp_near_candidate_region(self, tiny_setup):
        """VCPs are convex combinations of candidates, so they must lie in
        the candidate bounding box around the warm-started keypoints."""
        cfg, model, variables, src, R, t = tiny_setup
        kp, vcp, _ = model.apply(variables, src, src, R, t, train=False)
        from deepvcp.ops import apply_rigid

        kp_warm = apply_rigid(kp, R, t)
        extent = cfg.search_radius + cfg.voxel_len
        assert float(jnp.max(jnp.abs(vcp - kp_warm))) <= extent + 1e-5


class TestLossIntegration:
    def test_loss_and_grads_finite(self, tiny_setup):
        cfg, model, variables, src, R, t = tiny_setup
        from deepvcp.ops import apply_rigid

        tgt = apply_rigid(src[..., :3], R, t)
        tgt = jnp.concatenate([tgt, src[..., 3:]], axis=-1)
        params = variables["params"]
        other = {k: v for k, v in variables.items() if k != "params"}

        def loss_fn(p):
            kp, vcp, _ = model.apply({"params": p, **other}, src, tgt, R, t)
            return deepvcp_loss(kp, vcp, R, t, alpha=0.5).loss

        loss, grads = jax.value_and_grad(loss_fn)(params)
        assert np.isfinite(float(loss))
        leaves = jax.tree_util.tree_leaves(grads)
        assert all(np.isfinite(np.asarray(g)).all() for g in leaves)
        # the FE/CPG/DFE weights must actually receive gradient
        gnorm = sum(float(jnp.sum(jnp.abs(g))) for g in leaves)
        assert gnorm > 0

    def test_oracle_perfect_prediction(self, tiny_setup):
        """The dataset construction IS an oracle: if predicted VCPs equal the
        ground-truth-transformed keypoints, loss ~ 0 and the solved pose
        matches (R_true, t_true) (SURVEY.md §4)."""
        cfg, model, variables, src, R, t = tiny_setup
        from deepvcp.ops import apply_rigid
        from deepvcp.utils import rotation_geodesic_deg, translation_error

        kp, _, _ = model.apply(variables, src, src, R, t, train=False)
        y_perfect = apply_rigid(kp, R, t)
        res = deepvcp_loss(kp, y_perfect, R, t, alpha=0.5)
        assert float(res.loss) < 1e-4
        assert float(jnp.max(rotation_geodesic_deg(res.R, R))) < 0.1
        assert float(jnp.max(translation_error(res.t, t))) < 1e-3


class TestLossRobustness:
    def test_outlier_rejection_recovers_pose(self):
        """Corrupt 15% of correspondences; the two-pass solve must still
        recover the pose (ref deepVCP_loss.py:57-90 capability)."""
        from deepvcp.loss import deepvcp_loss
        from deepvcp.ops import apply_rigid
        from deepvcp.utils import (
            random_rotation,
            rotation_geodesic_deg,
            translation_error,
        )

        from deepvcp.ops import kabsch

        rng = np.random.default_rng(2)
        x = jnp.asarray(rng.uniform(-2, 2, (1, 64, 3)).astype(np.float32))
        R = jnp.asarray(random_rotation(rng).astype(np.float32))[None]
        t = jnp.asarray(rng.uniform(-1, 1, (1, 3)).astype(np.float32))
        y = apply_rigid(x, R, t)
        y_noisy = np.asarray(y).copy()
        y_noisy[:, :6] += rng.uniform(1.0, 2.0, (1, 6, 3))  # ~9% mild outliers
        res = deepvcp_loss(x, jnp.asarray(y_noisy), R, t, alpha=0.5)

        # two-pass refined pose beats the single naive solve...
        R1, t1 = kabsch(x, jnp.asarray(y_noisy))
        err2 = float(rotation_geodesic_deg(res.R, R)[0])
        err1 = float(rotation_geodesic_deg(R1, R)[0])
        assert err2 < err1
        # ...and recovers the pose to a few degrees / decimeters
        assert err2 < 3.0
        assert float(translation_error(res.t, t)[0]) < 0.3


class TestNeighborMethods:
    @pytest.mark.parametrize("method", ["banded", "windowed", "dense"])
    def test_forward_all_methods(self, method):
        """Every neighbor engine (banded gather-free, sorted-window,
        dense exact-oracle) runs the full forward with finite outputs and
        the right shapes — the engines differ in neighbor selection by
        design, so parity is architectural, not numerical."""
        import dataclasses

        cfg = dataclasses.replace(
            DeepVCPConfig.tiny(num_points=96, use_normal=False),
            neighbor_method=method,
        )
        model = DeepVCP(cfg=cfg)
        rng = np.random.default_rng(1)
        src = jnp.asarray(rng.uniform(-2, 2, (1, 96, 3)).astype(np.float32))
        tgt = jnp.asarray(rng.uniform(-2, 2, (1, 96, 3)).astype(np.float32))
        R = jnp.eye(3, dtype=jnp.float32)[None]
        t = jnp.zeros((1, 3), jnp.float32)
        variables = model.init(jax.random.key(0), src, tgt, R, t, train=False)
        kp, vcp, aux = jax.jit(
            lambda v, s, tg: model.apply(v, s, tg, R, t, train=False)
        )(variables, src, tgt)
        assert kp.shape == (1, cfg.num_keypoints, 3)
        assert vcp.shape == (1, cfg.num_keypoints, 3)
        assert np.isfinite(np.asarray(kp)).all()
        assert np.isfinite(np.asarray(vcp)).all()


class TestDefectFixFlags:
    """D12 (centered grid) and D13 (cloud-based source DFE neighborhoods)
    are config-gated; both parity modes must run, and the flags must
    actually change the computation."""

    def _run(self, **overrides):
        import dataclasses

        cfg = dataclasses.replace(
            DeepVCPConfig.tiny(num_points=96, use_normal=False), **overrides
        )
        model = DeepVCP(cfg=cfg)
        rng = np.random.default_rng(3)
        src = jnp.asarray(rng.uniform(-2, 2, (1, 96, 3)).astype(np.float32))
        tgt = jnp.asarray(rng.uniform(-2, 2, (1, 96, 3)).astype(np.float32))
        R = jnp.eye(3, dtype=jnp.float32)[None]
        t = jnp.zeros((1, 3), jnp.float32)
        variables = model.init(jax.random.key(5), src, tgt, R, t, train=False)
        kp, vcp, aux = model.apply(variables, src, tgt, R, t, train=False)
        return np.asarray(kp), np.asarray(vcp)

    @pytest.mark.parametrize("mode", ["cloud", "keypoints"])
    def test_src_neighbor_modes_run(self, mode):
        kp, vcp = self._run(dfe_src_neighbors=mode)
        assert np.isfinite(vcp).all()

    def test_src_neighbor_modes_differ(self):
        _, vcp_cloud = self._run(dfe_src_neighbors="cloud")
        _, vcp_kp = self._run(dfe_src_neighbors="keypoints")
        assert not np.allclose(vcp_cloud, vcp_kp)

    @pytest.mark.parametrize("centered,bias", [(True, 0.0), (False, -0.2)])
    def test_uniform_softmax_vcp_bias(self, centered, bias):
        """With the CPG convs zeroed the softmax is exactly uniform and the
        VCP is the candidate-grid mean: kp_warm + 0 under the D12 fix,
        kp_warm - voxel_len/2 per axis under reference parity — the
        structural bias the fix removes."""
        import dataclasses

        cfg = dataclasses.replace(
            DeepVCPConfig.tiny(num_points=96, use_normal=False),
            centered_grid=centered,
        )
        model = DeepVCP(cfg=cfg)
        rng = np.random.default_rng(3)
        src = jnp.asarray(rng.uniform(-2, 2, (1, 96, 3)).astype(np.float32))
        R = jnp.eye(3, dtype=jnp.float32)[None]
        t = jnp.zeros((1, 3), jnp.float32)
        variables = model.init(jax.random.key(5), src, src, R, t, train=False)
        variables = jax.tree_util.tree_map_with_path(
            lambda path, x: (
                jnp.zeros_like(x)
                if any(getattr(p, "key", None) == "cpg" for p in path)
                else x
            ),
            variables,
        )
        kp, vcp, _ = model.apply(variables, src, src, R, t, train=False)
        shift = np.asarray(vcp) - np.asarray(kp)  # identity warm start
        np.testing.assert_allclose(
            shift, np.broadcast_to(bias * np.ones(3), shift.shape), atol=1e-5
        )


class TestKeypointSelection:
    def test_salient_fps_spreads_keypoints(self):
        """On a density-gradient cloud, salient_fps keypoints must have a
        larger RMS lever arm than plain top-k (the round-3 lidar failure:
        top-k clustered in the dense core, lever 0.25 vs cloud 0.40, and
        per-keypoint VCP scatter became 80+ deg of rotation noise)."""
        import dataclasses

        base = DeepVCPConfig.tiny(num_points=128, use_normal=False)
        rng = np.random.default_rng(3)
        # 85% of points in a tight core, 15% spread wide
        core = rng.uniform(-0.15, 0.15, (109, 3))
        spread = rng.uniform(-2, 2, (19, 3))
        cloud = jnp.asarray(
            np.concatenate([core, spread]).astype(np.float32)
        )[None]
        eye = jnp.eye(3, dtype=jnp.float32)[None]
        t0 = jnp.zeros((1, 3), jnp.float32)

        levers = {}
        for mode in ("topk", "salient_fps"):
            cfg = dataclasses.replace(base, keypoint_selection=mode)
            model = DeepVCP(cfg=cfg)
            variables = model.init(
                jax.random.key(0), cloud, cloud, eye, t0, train=False
            )
            kp, _, aux = jax.jit(
                lambda v, s: model.apply(v, s, s, eye, t0, train=False)
            )(variables, cloud)
            k = np.asarray(kp)[0]
            levers[mode] = float(
                np.sqrt(((k - k.mean(0)) ** 2).sum(-1).mean())
            )
            assert kp.shape == (1, base.num_keypoints, 3)
            # selected saliencies must come from the top pool
            sal = np.asarray(aux["saliency"])[0]
            kp_sal = np.asarray(aux["keypoint_saliency"])[0]
            pool = np.sort(sal)[-base.keypoint_pool_mult
                                * base.num_keypoints:]
            assert kp_sal.min() >= pool.min() - 1e-6
        assert levers["salient_fps"] > 1.5 * levers["topk"], levers


class TestOracleRegistration:
    def test_pure_translation_recovered_without_training(self):
        """End-to-end architectural oracle for D12+D13: under a pure
        translation (FE features are translation-invariant by construction
        — every SA stage sees only local differences) with a GT warm start
        and a centered grid that contains the true offset (odd grid), the
        source keypoint's DFE input and the true candidate's DFE input are
        IDENTICAL up to neighbor order, which the max-pool erases. Hand-set
        CPG convs (logits = -beta * sum-of-cost) then make the softmax peak
        at the true candidate, so the untrained pipeline must recover the
        translation. The reference architecture fails this structurally:
        its source neighborhoods come from keypoints-only grouping (D13)
        and its grid average is biased (D12)."""
        import dataclasses

        cfg = dataclasses.replace(
            DeepVCPConfig.tiny(num_points=96, use_normal=False),
            neighbor_method="dense",
            # odd centered grid (gs=3): contains the exact center candidate
            search_radius=0.4,
            voxel_len=0.4,
            use_batchnorm=False,  # BN statistics are not per-branch-equal
        )
        assert cfg.grid_size % 2 == 1
        model = DeepVCP(cfg=cfg)
        rng = np.random.default_rng(7)
        src = jnp.asarray(rng.uniform(-2, 2, (1, 96, 3)).astype(np.float32))
        t_true = jnp.asarray(np.array([[0.31, -0.22, 0.17]], np.float32))
        R_true = jnp.eye(3, dtype=jnp.float32)[None]
        tgt = src + t_true[:, None, :]

        variables = model.init(
            jax.random.key(11), src, tgt, R_true, t_true, train=False
        )
        params = jax.tree_util.tree_map(lambda x: x, variables["params"])
        cpg = params["cpg"]
        beta = 100.0
        for li, name in enumerate(sorted(cpg.keys())):
            k = np.zeros(cpg[name]["kernel"].shape, np.float32)
            scale = -1.0 if li == 0 else (beta if li == 2 else 1.0)
            k[1, 1, 1, :, :] = scale
            cpg[name]["kernel"] = jnp.asarray(k)
            cpg[name]["bias"] = jnp.zeros_like(cpg[name]["bias"])
        variables = {**variables, "params": params}

        kp, vcp, aux = model.apply(
            variables, src, tgt, R_true, t_true, train=False
        )
        err = np.abs(np.asarray(vcp) - (np.asarray(kp) + np.asarray(t_true)[:, None, :]))
        assert err.max() < 5e-3, f"VCP error {err.max()} — oracle broken"

        from deepvcp.loss import svd_refine

        ref = svd_refine(kp, vcp)
        np.testing.assert_allclose(
            np.asarray(ref.t), np.asarray(t_true), atol=5e-3
        )
        np.testing.assert_allclose(
            np.asarray(ref.R), np.eye(3)[None], atol=5e-3
        )

    def test_rotation_recovered_without_training(self):
        """End-to-end architectural oracle for D14 that PINS the derotation
        DIRECTION (review finding: test_derotation_mechanics only asserts
        the output *differs* under a rotated init, and the translation
        oracle uses R_true=I where a transposed einsum is also a no-op).

        Construction: zero out the FE so features vanish (FE outputs are
        rotation-VARIANT, so unlike the translation oracle they cannot be
        relied on to match across branches); the DFE inputs then reduce to
        pure local coordinates. With tgt = src @ R_true^T + t_true and a GT
        warm start, the true (center) candidate's derotated neighborhood is
        R_true^T R_true (nb - kp) = the source neighborhood exactly (up to
        kNN order, which the DFE max-pool erases), so hand-set CPG convs
        must recover the pose. If the einsum rotated by R_true instead of
        R_true^T the sets would differ by R_true^2 and the oracle fails."""
        import dataclasses

        cfg = dataclasses.replace(
            DeepVCPConfig.tiny(num_points=96, use_normal=False),
            neighbor_method="dense",
            search_radius=0.4,
            voxel_len=0.4,
            use_batchnorm=False,
            dfe_src_neighbors="cloud",
            derotate_tgt_neighborhoods=True,
        )
        assert cfg.grid_size % 2 == 1
        model = DeepVCP(cfg=cfg)
        rng = np.random.default_rng(13)
        src = jnp.asarray(rng.uniform(-2, 2, (1, 96, 3)).astype(np.float32))
        R_true = jnp.asarray(
            np.asarray(random_rotation(rng))[None].astype(np.float32)
        )
        t_true = jnp.asarray(np.array([[0.31, -0.22, 0.17]], np.float32))
        tgt = jnp.einsum("bnj,bij->bni", src, R_true) + t_true[:, None, :]

        variables = model.init(
            jax.random.key(11), src, tgt, R_true, t_true, train=False
        )
        params = jax.tree_util.tree_map(lambda x: x, variables["params"])
        # zero the FE: rotation-variant features out of the comparison
        params["fe"] = jax.tree_util.tree_map(
            jnp.zeros_like, params["fe"]
        )
        cpg = params["cpg"]
        beta = 100.0
        for li, name in enumerate(sorted(cpg.keys())):
            k = np.zeros(cpg[name]["kernel"].shape, np.float32)
            scale = -1.0 if li == 0 else (beta if li == 2 else 1.0)
            k[1, 1, 1, :, :] = scale
            cpg[name]["kernel"] = jnp.asarray(k)
            cpg[name]["bias"] = jnp.zeros_like(cpg[name]["bias"])
        variables = {**variables, "params": params}

        kp, vcp, aux = model.apply(
            variables, src, tgt, R_true, t_true, train=False
        )
        kp_true = np.einsum(
            "bnj,bij->bni", np.asarray(kp), np.asarray(R_true)
        ) + np.asarray(t_true)[:, None, :]
        err = np.abs(np.asarray(vcp) - kp_true)
        assert err.max() < 5e-3, f"VCP error {err.max()} — rotation oracle"

        from deepvcp.loss import svd_refine

        ref = svd_refine(kp, vcp)
        np.testing.assert_allclose(
            np.asarray(ref.R), np.asarray(R_true), atol=5e-3
        )
        np.testing.assert_allclose(
            np.asarray(ref.t), np.asarray(t_true), atol=5e-3
        )

    def test_derotation_mechanics(self):
        """D14: derotation is a no-op at identity init and changes the
        forward under a rotated init."""
        import dataclasses

        base = DeepVCPConfig.tiny(num_points=96, use_normal=False)
        rng = np.random.default_rng(9)
        src = jnp.asarray(rng.uniform(-2, 2, (1, 96, 3)).astype(np.float32))
        tgt = jnp.asarray(rng.uniform(-2, 2, (1, 96, 3)).astype(np.float32))
        eye = jnp.eye(3, dtype=jnp.float32)[None]
        t0 = jnp.zeros((1, 3), jnp.float32)
        from deepvcp.utils import random_rotation

        Rr = jnp.asarray(
            np.asarray(random_rotation(np.random.default_rng(4)))[None]
            .astype(np.float32)
        )
        outs = {}
        for flag in (True, False):
            cfg = dataclasses.replace(base, derotate_tgt_neighborhoods=flag)
            model = DeepVCP(cfg=cfg)
            variables = model.init(
                jax.random.key(2), src, tgt, eye, t0, train=False
            )
            _, vcp_id, _ = model.apply(
                variables, src, tgt, eye, t0, train=False
            )
            _, vcp_rot, _ = model.apply(
                variables, src, tgt, Rr, t0, train=False
            )
            outs[flag] = (np.asarray(vcp_id), np.asarray(vcp_rot))
        np.testing.assert_allclose(outs[True][0], outs[False][0], atol=1e-6)
        assert not np.allclose(outs[True][1], outs[False][1])


class TestRegistrarExtentMonitor:
    def test_rewarns_on_scale_change(self):
        """Round-4 review: the extent preflight gated on the FIRST batch
        forever; the in-graph monitor must re-warn when a long-lived
        Registrar is later fed differently-scaled clouds."""
        import warnings

        from deepvcp.registration import Registrar

        cfg = DeepVCPConfig.tiny(num_points=96, use_normal=False)
        model = DeepVCP(cfg=cfg)
        rng = np.random.default_rng(11)

        def cloud(extent):
            half = extent / 2.0
            return jnp.asarray(
                rng.uniform(-half, half, (1, 96, 3)).astype(np.float32))

        small = cloud(cfg.spatial_extent)       # in-spec (extent 4)
        eye = jnp.eye(3, dtype=jnp.float32)[None]
        t0 = jnp.zeros((1, 3), jnp.float32)
        variables = model.init(
            jax.random.key(0), small, small, eye, t0, train=False)
        reg = Registrar(cfg, variables, refine_iters=1)

        def run(src):
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                out = reg(src, src)
                np.asarray(out.R)  # flush the stream
                jax.effects_barrier()  # drain the async extent callback
            return [w for w in rec
                    if "spatial_extent" in str(w.message)]

        assert not run(small)                   # in-spec: silent
        assert run(cloud(20 * cfg.spatial_extent))   # first violation
        # same out-of-spec scale again: no re-warn (not materially moved)
        assert not run(cloud(20 * cfg.spatial_extent))
        # materially different out-of-spec scale: warns again — the
        # round-4 staleness defect
        assert run(cloud(200 * cfg.spatial_extent))


class TestCascadeRegistrar:
    def test_cascade_runs_and_guards(self):
        """Coarse->fine cascade (registration.CascadeRegistrar): stage 2
        warm-starts from stage 1's pose, score blocks concatenate, and
        the per-stage guards keep the accepted score non-increasing at
        every stage boundary."""
        import dataclasses

        from deepvcp.registration import CascadeRegistrar, Registrar

        cfg_c = DeepVCPConfig.tiny(num_points=96, use_normal=False)
        cfg_f = dataclasses.replace(
            cfg_c, search_radius=cfg_c.search_radius * 0.6,
            voxel_len=cfg_c.voxel_len * 0.5)
        model = DeepVCP(cfg=cfg_c)
        rng = np.random.default_rng(3)
        src = jnp.asarray(rng.uniform(-2, 2, (2, 96, 3)).astype(np.float32))
        eye = jnp.eye(3, dtype=jnp.float32)[None].repeat(2, 0)
        t0 = jnp.zeros((2, 3), jnp.float32)
        variables = model.init(jax.random.key(1), src, src, eye, t0,
                               train=False)
        # fine stage shares params (CPG convs are grid-size-agnostic)
        stages = [
            Registrar(cfg_c, variables, refine_iters=2),
            Registrar(cfg_f, variables, refine_iters=1),
        ]
        casc = CascadeRegistrar(stages)
        assert casc.cfg is cfg_f
        R_true = jnp.asarray(np.stack(
            [np.asarray(jax.random.orthogonal(jax.random.key(7), 3))] * 2))
        out = casc(src, src)
        assert out.scores.shape == (2, (2 + 1) + (1 + 1))
        sc = np.asarray(out.scores)
        # guard invariant: within each stage block the running min never
        # increases, and stage 2's init column equals... stage 1's final
        # accepted pose scored under stage 2's keypoints (not numerically
        # identical) — so assert the global accepted score (min of all
        # accepted columns) is realized by the returned pose via
        # finiteness + non-worsening vs the identity init column
        assert np.isfinite(sc).all()
        best = np.minimum.accumulate(sc[:, :3], axis=1)
        assert (np.diff(best, axis=1) <= 1e-7).all()
        assert np.isfinite(np.asarray(out.R)).all()

    def test_cascade_rejects_mismatched_stages(self):
        import dataclasses

        from deepvcp.registration import CascadeRegistrar, Registrar

        cfg_a = DeepVCPConfig.tiny(num_points=96, use_normal=False)
        cfg_b = dataclasses.replace(cfg_a, num_points=128)
        model = DeepVCP(cfg=cfg_a)
        rng = np.random.default_rng(3)
        src = jnp.asarray(rng.uniform(-2, 2, (1, 96, 3)).astype(np.float32))
        eye = jnp.eye(3, dtype=jnp.float32)[None]
        t0 = jnp.zeros((1, 3), jnp.float32)
        variables = model.init(jax.random.key(1), src, src, eye, t0,
                               train=False)
        with pytest.raises(ValueError, match="input contract"):
            CascadeRegistrar([
                Registrar(cfg_a, variables),
                Registrar(cfg_b, variables),
            ])
        with pytest.raises(ValueError, match="at least one"):
            CascadeRegistrar([])


class TestCandidateKnnModes:
    def test_exact_mode_on_banded_arch(self):
        """candidate_knn='exact' must run the banded-arch checkpoint
        with exact selection and produce output close to the approx
        default (recall 0.978 selection-level -> near-identical VCPs on
        a tiny cloud where approx==exact)."""
        import dataclasses

        cfg = DeepVCPConfig.tiny(num_points=96, use_normal=False)
        rng = np.random.default_rng(5)
        src = jnp.asarray(rng.uniform(-2, 2, (1, 96, 3)).astype(np.float32))
        tgt = jnp.asarray(rng.uniform(-2, 2, (1, 96, 3)).astype(np.float32))
        eye = jnp.eye(3, dtype=jnp.float32)[None]
        t0 = jnp.zeros((1, 3), jnp.float32)
        model_a = DeepVCP(cfg=cfg)
        variables = model_a.init(jax.random.key(0), src, tgt, eye, t0,
                                 train=False)
        _, vcp_a, _ = model_a.apply(variables, src, tgt, eye, t0,
                                    train=False)
        cfg_e = dataclasses.replace(cfg, candidate_knn="exact")
        model_e = DeepVCP(cfg=cfg_e)
        _, vcp_e, _ = model_e.apply(variables, src, tgt, eye, t0,
                                    train=False)
        assert np.isfinite(np.asarray(vcp_e)).all()
        # tiny clouds: approx_min_k with high recall == exact -> close
        np.testing.assert_allclose(np.asarray(vcp_a), np.asarray(vcp_e),
                                   atol=1e-3)

    def test_invalid_mode_raises(self):
        import dataclasses

        cfg = dataclasses.replace(DeepVCPConfig.tiny(), candidate_knn="fast")
        with pytest.raises(ValueError, match="candidate_knn"):
            cfg.resolve()


class TestRotationLossTerm:
    def test_rot_weight_zero_is_reference_semantics(self):
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.uniform(-1, 1, (2, 32, 3)).astype(np.float32))
        R = jnp.asarray(np.stack(
            [random_rotation(np.random.default_rng(i)) for i in range(2)]
        ).astype(np.float32))
        t = jnp.asarray(rng.uniform(-1, 1, (2, 3)).astype(np.float32))
        y = jnp.einsum("bni,bji->bnj", x, R) + t[:, None] \
            + 0.05 * jnp.asarray(rng.normal(size=(2, 32, 3)).astype(np.float32))
        a = deepvcp_loss(x, y, R, t)
        b = deepvcp_loss(x, y, R, t, rot_weight=0.0)
        assert float(a.loss) == float(b.loss)
        # the term is the mean Frobenius distance of the solved pose
        expected = np.mean([np.linalg.norm(np.asarray(a.R[i]) -
                                           np.asarray(R[i]))
                            for i in range(2)])
        np.testing.assert_allclose(float(a.rot_fro), expected, rtol=1e-4)
        assert expected > 0

    def test_rot_term_has_finite_gradient_at_zero_error(self):
        """The arccos geodesic's gradient blows up at zero rotation
        error; the Frobenius surrogate must stay finite when the solve
        recovers the pose exactly."""
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.uniform(-1, 1, (1, 16, 3)).astype(np.float32))
        R = jnp.asarray(
            random_rotation(np.random.default_rng(2))[None].astype(np.float32))
        t = jnp.asarray(rng.uniform(-1, 1, (1, 3)).astype(np.float32))
        y_exact = jnp.einsum("bni,bji->bnj", x, R) + t[:, None]

        def f(y):
            return deepvcp_loss(x, y, R, t, rot_weight=5.0).loss

        g = jax.grad(f)(y_exact)
        assert np.isfinite(np.asarray(g)).all()
