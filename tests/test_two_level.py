"""Two-level candidate grouping (ops/two_level.py): exactness of the
table-row gather, recall of the two-level selection vs exact flat KNN
at the covered operating scales, and the config gate."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deepvcp.config import DeepVCPConfig


def _cloud(rng, B, N, extent):
    return jnp.asarray(
        rng.uniform(-extent / 2, extent / 2, (B, N, 3)).astype(np.float32))


class TestTwoLevelRows:
    def test_matches_flat_exact_when_table_covers(self):
        """With T=N the table is the whole cloud, so two-level selection
        must reproduce the flat exact k-NN rows (up to approx_min_k's
        recall on tiny inputs, which is exact here)."""
        from deepvcp.ops.grouping import index_points
        from deepvcp.ops.knn import knn
        from deepvcp.ops.two_level import two_level_rows

        rng = np.random.default_rng(2)
        B, N, K, C, k = 1, 256, 4, 8, 4
        tgt = _cloud(rng, B, N, 20.0)
        rows = jnp.concatenate(
            [tgt, jnp.asarray(rng.normal(size=(B, N, 5)).astype(np.float32))],
            axis=-1)
        centers = _cloud(rng, B, K, 16.0)[:, :, :]
        cand = centers[:, :, None, :] + jnp.asarray(
            rng.uniform(-1, 1, (B, K, C, 3)).astype(np.float32))
        out = two_level_rows(tgt, rows, centers, cand, k,
                             table_size=N)
        _, idx = knn(tgt, cand.reshape(B, K * C, 3), k)
        ref = index_points(rows, idx).reshape(B, K, C, k, -1)
        # sets of selected rows must match (order can differ on ties)
        out_s = np.sort(np.asarray(out), axis=-2)
        ref_s = np.sort(np.asarray(ref), axis=-2)
        np.testing.assert_allclose(out_s, ref_s, atol=1e-5)

    def test_recall_at_bench_scale(self):
        """Extent-20 uniform clouds at a scaled-down operating point:
        the T-table must capture essentially all true neighbors (module
        docstring coverage bound)."""
        from deepvcp.ops.knn import knn
        from deepvcp.ops.two_level import two_level_rows

        rng = np.random.default_rng(3)
        B, N, K, C, k, T = 1, 2048, 8, 27, 8, 256
        tgt = _cloud(rng, B, N, 20.0)
        centers = _cloud(rng, B, K, 16.0)
        # candidate cube matching the default grid reach (+-1.2)
        offs = jnp.asarray(
            rng.uniform(-1.2, 1.2, (B, K, C, 3)).astype(np.float32))
        cand = centers[:, :, None, :] + offs
        rows = tgt
        out = two_level_rows(tgt, rows, centers, cand, k, table_size=T,
                             select_dtype="bfloat16")
        _, idx = knn(tgt, cand.reshape(B, K * C, 3), k)
        ref = jnp.take_along_axis(
            tgt, idx.reshape(B, K * C * k)[..., None], axis=-2
        ).reshape(B, K, C, k, 3)
        # recall: fraction of exact neighbor coordinates reproduced
        out_f = np.asarray(out).reshape(B, K, C, k, 3)
        ref_f = np.asarray(ref)
        match = 0
        for b in range(B):
            for kk in range(K):
                for c in range(C):
                    o = {tuple(np.round(r, 5)) for r in out_f[b, kk, c]}
                    r_ = {tuple(np.round(r, 5)) for r in ref_f[b, kk, c]}
                    match += len(o & r_) / k
        recall = match / (B * K * C)
        assert recall >= 0.95, recall

    def test_config_gate(self):
        base = DeepVCPConfig(num_points=1024, use_normal=False)
        # measured default: flat (two-level lost the W2/W3 benchmarks)
        assert not base.use_two_level_tgt_knn
        auto = dataclasses.replace(base, tgt_knn="auto")
        # auto at the bench operating point: extent 20, reach 1.0 -> on
        assert auto.use_two_level_tgt_knn
        # ModelNet scale: cube covers half the cloud -> off
        mn = dataclasses.replace(auto, spatial_extent=2.5)
        assert not mn.use_two_level_tgt_knn
        # exact-selection fidelity mode forces the flat path
        ex = dataclasses.replace(auto, candidate_knn="exact")
        assert not ex.use_two_level_tgt_knn
        # explicit override wins over the extent heuristic
        forced = dataclasses.replace(mn, tgt_knn="two_level")
        assert forced.use_two_level_tgt_knn
        off = dataclasses.replace(base, tgt_knn="flat")
        assert not off.use_two_level_tgt_knn
        with pytest.raises(ValueError, match="tgt_knn"):
            dataclasses.replace(base, tgt_knn="bogus").resolve()

    def test_model_forward_two_level_close_to_flat(self):
        """End-to-end: the banded model with tgt_knn='two_level' at a
        KITTI-like scale must produce VCPs close to the flat path (same
        weights; selection differences only move near-ties)."""
        from deepvcp.models import DeepVCP

        rng = np.random.default_rng(4)
        N = 256
        cfg = dataclasses.replace(
            DeepVCPConfig.tiny(num_points=N, use_normal=False),
            spatial_extent=24.0, tgt_knn="flat",
            sa_layers=tuple(
                dataclasses.replace(l, radius=l.radius * 6.0)
                for l in DeepVCPConfig.tiny().sa_layers),
        )
        src = _cloud(rng, 1, N, 20.0)
        tgt = _cloud(rng, 1, N, 20.0)
        eye = jnp.eye(3, dtype=jnp.float32)[None]
        t0 = jnp.zeros((1, 3), jnp.float32)
        model_f = DeepVCP(cfg=cfg)
        variables = model_f.init(jax.random.key(0), src, tgt, eye, t0,
                                 train=False)
        _, vcp_f, _ = model_f.apply(variables, src, tgt, eye, t0,
                                    train=False)
        cfg2 = dataclasses.replace(cfg, tgt_knn="two_level",
                                   tgt_knn_table=N)
        model_t = DeepVCP(cfg=cfg2)
        _, vcp_t, _ = model_t.apply(variables, src, tgt, eye, t0,
                                    train=False)
        assert np.isfinite(np.asarray(vcp_t)).all()
        np.testing.assert_allclose(np.asarray(vcp_f), np.asarray(vcp_t),
                                   atol=1e-2)


class TestTwoLevelGradient:
    def test_rows_gradient_matches_flat_gather(self):
        """With T=N the table rows are the whole cloud, so the gradient of
        the gathered rows w.r.t. the row features equals that of the flat
        exact-KNN gather (training forwards route through this path)."""
        from deepvcp.ops.grouping import index_points
        from deepvcp.ops.knn import knn
        from deepvcp.ops.two_level import two_level_rows

        rng = np.random.default_rng(8)
        B, N, K, C, k = 1, 128, 2, 4, 4
        tgt = jnp.asarray(
            rng.uniform(-10, 10, (B, N, 3)).astype(np.float32))
        feat = jnp.asarray(rng.normal(size=(B, N, 5)).astype(np.float32))
        centers = jnp.asarray(
            rng.uniform(-8, 8, (B, K, 3)).astype(np.float32))
        cand = centers[:, :, None, :] + jnp.asarray(
            rng.uniform(-1, 1, (B, K, C, 3)).astype(np.float32))
        _, idx = knn(tgt, cand.reshape(B, K * C, 3), k)

        def loss_two_level(ft):
            rows = jnp.concatenate([tgt, ft], axis=-1)
            out = two_level_rows(tgt, rows, centers, cand, k, table_size=N)
            return jnp.sum(out[..., 3:] ** 2)

        def loss_flat(ft):
            return jnp.sum(index_points(ft, idx) ** 2)

        g_two = jax.grad(loss_two_level)(feat)
        g_flat = jax.grad(loss_flat)(feat)
        np.testing.assert_allclose(np.asarray(g_two), np.asarray(g_flat),
                                   atol=1e-5)
