"""The band-max Pallas kernels (Triton route) against numpy oracles and
the XLA static band, in interpret mode so they run on the CPU; the
compiled kernels are checked on the card by the `gpu` test at the end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepvcp import ops
from deepvcp.ops.pallas import banded_masked_max, banded_masked_max_grad


def _make_cloud(rng, B, N, spread):
    xyz = np.sort(
        rng.uniform(-spread, spread, (B, N, 1)).astype(np.float32), axis=1)
    return np.concatenate(
        [xyz, rng.uniform(-spread, spread, (B, N, 2)).astype(np.float32)],
        -1)


class TestBandMaxKernel:
    def _oracle(self, xyz, u, radius, half):
        B, N, C = u.shape
        out = np.full((B, N, C), -np.inf, np.float32)
        for b in range(B):
            for q in range(N):
                lo, hi = max(0, q - half), min(N, q + half + 1)
                for n in range(lo, hi):
                    d2 = np.sum((xyz[b, n] - xyz[b, q]) ** 2)
                    if d2 <= radius * radius:
                        out[b, q] = np.maximum(out[b, q], u[b, n])
        return out

    def test_matches_oracle(self):
        rng = np.random.default_rng(1)
        B, N, C = 2, 200, 8
        xyz = _make_cloud(rng, B, N, 5.0)
        u = rng.standard_normal((B, N, C)).astype(np.float32)
        radius = 1.0
        got = np.asarray(banded_masked_max(
            jnp.asarray(xyz), jnp.asarray(u), radius, interpret=True))
        # the kernel's slab is exact: an oracle window of the whole cloud
        want = self._oracle(xyz, u, radius, N)
        np.testing.assert_array_equal(got, want)

    def test_self_neighbor_always_included(self):
        rng = np.random.default_rng(2)
        xyz = np.sort(rng.uniform(-3, 3, (1, 150, 3)).astype(np.float32),
                      axis=1)
        u = rng.standard_normal((1, 150, 4)).astype(np.float32)
        got = np.asarray(banded_masked_max(
            jnp.asarray(xyz), jnp.asarray(u), 1e-4, interpret=True))
        # with a tiny radius every point's pool >= its own u
        assert (got >= u - 1e-5).all()


class TestBandedMaxPoolVJP:
    def test_custom_bwd_matches_autodiff(self):
        """The indicator backward must equal XLA autodiff of the static-
        band formula (random floats: no exact ties)."""
        from deepvcp.models.fused_sa import banded_max_pool, xla_banded_max

        rng = np.random.default_rng(3)
        B, N, C = 2, 300, 8
        radius, window, tile = 1.0, 64, 64
        xyz = jnp.asarray(_make_cloud(rng, B, N, 4.0))
        u = jnp.asarray(rng.standard_normal((B, N, C)).astype(np.float32))

        def loss_custom(uu):
            out = banded_max_pool(xyz, uu, radius, window, tile)
            return jnp.sum(jnp.sin(out) * jnp.cos(out * 0.5))

        def loss_ref(uu):
            out = xla_banded_max(xyz, uu, radius, window, tile)
            return jnp.sum(jnp.sin(out) * jnp.cos(out * 0.5))

        g_custom = np.asarray(jax.grad(loss_custom)(u))
        g_ref = np.asarray(jax.grad(loss_ref)(u))
        np.testing.assert_allclose(g_custom, g_ref, atol=1e-5)

    def test_forward_value_unchanged(self):
        from deepvcp.models.fused_sa import banded_max_pool, xla_banded_max

        rng = np.random.default_rng(4)
        xyz = jnp.asarray(_make_cloud(rng, 1, 200, 3.0))
        u = jnp.asarray(rng.standard_normal((1, 200, 4)).astype(np.float32))
        a = banded_max_pool(xyz, u, 0.8, 64, 64)
        b = xla_banded_max(xyz, u, 0.8, 64, 64)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestBandMaxGradKernel:
    """The backward kernel (exact-slab indicator sweep) vs a numpy oracle
    of the TRUE in-radius max's VJP — including the dense-cluster case
    where a static band under-covers."""

    def _fwd_grad_oracle(self, xyz, u, g, radius):
        B, N, C = u.shape
        out = np.full((B, N, C), -1e30, np.float32)
        grad = np.zeros((B, N, C), np.float32)
        for b in range(B):
            for q in range(N):
                d2 = np.sum((xyz[b] - xyz[b, q]) ** 2, axis=-1)
                hit = d2 <= radius * radius
                if hit.any():
                    out[b, q] = u[b, hit].max(axis=0)
        for b in range(B):
            for q in range(N):
                d2 = np.sum((xyz[b] - xyz[b, q]) ** 2, axis=-1)
                for n in np.nonzero(d2 <= radius * radius)[0]:
                    took = u[b, n] == out[b, q]
                    grad[b, n] += np.where(took, g[b, q], 0.0)
        return out, grad

    @pytest.mark.parametrize("w,chunk", [(16, 16), (32, 32)])
    @pytest.mark.parametrize(
        "B,N,C,spread,radius",
        [
            (2, 200, 8, 5.0, 1.0),
            # dense cluster: the in-radius slab spans ~half the cloud —
            # far more than any static band
            (1, 256, 8, 1.0, 0.8),
            # wide radius and N not a multiple of the tile: slabs run to
            # the end of the cloud and the last chunk reads the padding
            (1, 300, 4, 6.0, 5.0),
        ],
    )
    def test_matches_oracle(self, B, N, C, spread, radius, w, chunk):
        rng = np.random.default_rng(7)
        xyz = _make_cloud(rng, B, N, spread)
        u = rng.standard_normal((B, N, C)).astype(np.float32)
        g = rng.standard_normal((B, N, C)).astype(np.float32)
        out, want = self._fwd_grad_oracle(xyz, u, g, radius)
        got = np.asarray(banded_masked_max_grad(
            jnp.asarray(xyz), jnp.asarray(u), jnp.asarray(out),
            jnp.asarray(g), radius, w=w, chunk=chunk, interpret=True))
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_production_call_signature(self):
        """Drive the kernels exactly as models/fused_sa.banded_max_pool
        does on the GPU: default block sizes, through the custom VJP."""
        from deepvcp.models import fused_sa

        rng = np.random.default_rng(11)
        B, N, C, radius = 1, 300, 4, 5.0
        xyz = _make_cloud(rng, B, N, 6.0)
        u = rng.standard_normal((B, N, C)).astype(np.float32)
        g = rng.standard_normal((B, N, C)).astype(np.float32)
        out, want = self._fwd_grad_oracle(xyz, u, g, radius)
        got = np.asarray(banded_masked_max_grad(
            jnp.asarray(xyz), jnp.asarray(u), jnp.asarray(out),
            jnp.asarray(g), float(radius), interpret=True))
        np.testing.assert_allclose(got, want, atol=1e-5)
        # the custom VJP's kernel branch calls the same entry points
        assert fused_sa.banded_masked_max is banded_masked_max
        assert fused_sa.banded_masked_max_grad is banded_masked_max_grad

    def test_fwd_bwd_pair_consistent(self):
        """Kernel forward + kernel backward must be a consistent VJP pair:
        backward(forward's residuals) == oracle grad of the exact in-radius
        max."""
        rng = np.random.default_rng(8)
        B, N, C, radius = 1, 300, 4, 0.9
        xyz = _make_cloud(rng, B, N, 3.0)
        u = rng.standard_normal((B, N, C)).astype(np.float32)
        g = rng.standard_normal((B, N, C)).astype(np.float32)
        out = np.asarray(banded_masked_max(
            jnp.asarray(xyz), jnp.asarray(u), radius, w=16, chunk=32,
            interpret=True))
        oracle_out, want = self._fwd_grad_oracle(xyz, u, g, radius)
        np.testing.assert_allclose(out, oracle_out, atol=1e-6)
        got = np.asarray(banded_masked_max_grad(
            jnp.asarray(xyz), jnp.asarray(u), jnp.asarray(out),
            jnp.asarray(g), radius, w=16, chunk=32, interpret=True))
        np.testing.assert_allclose(got, want, atol=1e-5)


class TestPoolingEngine:
    @pytest.mark.parametrize("backend,engine",
                             [("cpu", "xla_band"), ("gpu", "triton")])
    def test_engine_for_backend(self, backend, engine):
        from deepvcp.engine import pooling_engine

        assert pooling_engine(backend) == engine

    def test_slab_audit_follows_engine(self, monkeypatch):
        """The Registrar's slab-occupancy audit runs wherever the static
        band does, and not where the exact-slab kernel runs."""
        import warnings

        from deepvcp import DeepVCPConfig, registration
        from deepvcp.models import DeepVCP

        import dataclasses

        cfg = dataclasses.replace(
            DeepVCPConfig.tiny(num_points=1024, use_normal=False),
            spatial_extent=20.0)
        rng = np.random.default_rng(0)
        # density-gradient cloud: most points in a thin slab along x, far
        # more than the static window sized for a uniform cloud holds
        core = rng.uniform([-0.05, -2, -2], [0.05, 2, 2], (896, 3))
        rest = rng.uniform(-10, 10, (128, 3))
        src = jnp.asarray(np.concatenate([core, rest])[None]
                          .astype(np.float32))
        eye = jnp.eye(3, dtype=jnp.float32)[None]
        t0 = jnp.zeros((1, 3), jnp.float32)
        variables = DeepVCP(cfg=cfg).init(jax.random.key(0), src, src, eye,
                                          t0)
        warned = {}
        for engine in ("xla_band", "triton"):
            monkeypatch.setattr(registration, "pooling_engine",
                                lambda e=engine: e)
            reg = registration.Registrar(cfg, variables)
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                reg._check_extent(src)
            warned[engine] = any("under-cover" in str(w.message)
                                 for w in rec)
        assert warned == {"xla_band": True, "triton": False}


class TestFarthestPointSample:
    @staticmethod
    def _oracle(xyz, npoint):
        B, N, _ = xyz.shape
        out = np.zeros((B, npoint), np.int32)
        for b in range(B):
            dist = np.full(N, np.inf)
            far = 0
            for i in range(npoint):
                out[b, i] = far
                dist = np.minimum(
                    dist, np.sum((xyz[b] - xyz[b, far]) ** 2, axis=-1))
                far = int(np.argmax(dist))
        return out

    @pytest.mark.parametrize("B,N,npoint", [(1, 64, 8), (2, 200, 32)])
    def test_matches_numpy_oracle(self, B, N, npoint):
        rng = np.random.default_rng(7)
        xyz = rng.uniform(-3, 3, (B, N, 3)).astype(np.float32)
        got = ops.farthest_point_sample(jnp.asarray(xyz), npoint)
        np.testing.assert_array_equal(np.asarray(got),
                                      self._oracle(xyz, npoint))


@pytest.mark.gpu
@pytest.mark.parametrize("C,radius", [(16, 0.1), (32, 0.2), (64, 0.4)])
def test_compiled_kernels_match_reference(gpu_device, C, radius):
    """The kernels compiled for the card at the SA stages' widths, against
    the static band with a window covering the whole cloud."""
    from deepvcp.models.fused_sa import xla_banded_max

    rng = np.random.default_rng(0)
    N = 4096
    xyz = jnp.asarray(_make_cloud(rng, 1, N, 1.25))
    u = jnp.asarray(rng.standard_normal((1, N, C)).astype(np.float32))
    g = jnp.asarray(rng.standard_normal((1, N, C)).astype(np.float32))
    got = banded_masked_max(xyz, u, radius)
    want = xla_banded_max(xyz, u, radius, N, 256)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    want_grad = jax.jit(lambda v, c: jax.vjp(
        lambda vv: xla_banded_max(xyz, vv, radius, N, 256), v)[1](c)[0])(u, g)
    np.testing.assert_allclose(
        np.asarray(banded_masked_max_grad(xyz, u, got, g, radius)),
        np.asarray(want_grad), atol=1e-5, rtol=1e-5)
