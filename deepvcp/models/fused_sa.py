"""Gather-free banded set abstraction — the FE stage of the default
engine.

Gather-based SA grouping moves nsample rows per query; this stage removes
every gather and every sort-of-[S,N] from the hot path:

1.  The cloud is sorted along one spatial axis (one cheap 1-D argsort,
    done once for the whole FE stack) and reshaped into T tiles of `tile`
    points — a free reshape.
2.  Each tile's candidate neighborhood is its slab along the sort axis:
    on the GPU the exact slab, swept by the Pallas kernels of
    ops/pallas/band_max.py; elsewhere a static band of Kb adjacent tiles,
    built with `jnp.roll` + concat and sized by `window_for(N, r,
    extent)` (wrap-around pairs are killed by the true 3-D distance
    mask). deepvcp.engine picks between them.
3.  The neighborhood aggregation is restructured so the only per-pair
    computation is ADDITIVE: the first projection of the reference SA,
    Dense(concat(x_n - x_q, f_n)) = (Wx x_n + Wf f_n) - Wx x_q + b,
    is a difference of per-point projections. The pair tensor
    [N, band, c0] exists only inside a fused broadcast-subtract-max —
    it is never materialized. ReLU commutes with max (both monotone:
    max(relu(h)) == relu(max(h))), so pooling directly after the first
    projection is exact.
4.  The remaining MLP widths run per-POINT after pooling (plain [N, c]
    matmuls). This is the designed deviation from the reference, which
    applies its full conv stack per-pair before pooling
    (pointnet2_utils.py:196-200): per-pair depth costs band/nsample ~ 20-80x
    the reference FLOPs for no gather savings, while pooled-then-
    pointwise keeps the same receptive field through stage stacking. The
    neighbor set is "all in-radius points in the band" — a cap-free
    superset of the reference's first-nsample selection (D1-adjacent).
    The reference MLP-then-pool architecture remains available via
    DeepVCPConfig(neighbor_method="windowed") (sort-free gathers) or
    "dense" (exact [S, N] oracle semantics).

BatchNorm is applied to the pooled per-point activations (masked pair
statistics are unnecessary: pooled rows are per-point, so plain BN over
[B, N] is exact), with running stats for eval — same state layout as the
gather path.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import jax
import jax.numpy as jnp

from deepvcp.config import SALayerConfig
from deepvcp.engine import pooling_engine
from deepvcp.models.nn import BatchNorm, Dense, Module, relu, zeros
from deepvcp.ops.pallas.band_max import (
    banded_masked_max,
    banded_masked_max_grad,
)

_NEG = jnp.float32(-1e30)


def pad_to_tiles(x: jax.Array, tile: int, pad_value: float) -> jax.Array:
    """[B, N, C] -> [B, Np, C] with Np the next multiple of tile."""
    pad = (-x.shape[1]) % tile
    if pad == 0:
        return x
    return jnp.pad(
        x, [(0, 0), (0, pad), (0, 0)], constant_values=pad_value
    )


def band_of(tiles: jax.Array, half_tiles: int) -> jax.Array:
    """[B, T, w, C] -> [B, T, (2*half_tiles+1)*w, C]: the tile plus
    `half_tiles` neighbors on each side (torus roll; callers mask by true
    distance, which kills wrap-around pairs whenever extent > 2r)."""
    parts = [
        jnp.roll(tiles, s, axis=1)
        for s in range(half_tiles, -half_tiles - 1, -1)
    ]
    return jnp.concatenate(parts, axis=2)


def xla_banded_max(
    sorted_xyz: jax.Array,
    u: jax.Array,
    radius: float,
    window: int,
    tile: int,
) -> jax.Array:
    """Static-band masked max (pure XLA): for each point, the per-channel
    max of u over all in-radius points within the roll/concat band. The
    differentiable reference implementation behind `banded_max_pool` (and
    the CPU path). Returns [B, N, C] in u's dtype."""
    B, N, _ = sorted_xyz.shape
    C = u.shape[-1]
    w = min(tile, N)
    r2 = jnp.asarray(radius * radius, sorted_xyz.dtype)
    xyz_p = pad_to_tiles(sorted_xyz, w, 1e7)
    u_p = pad_to_tiles(u, w, 0.0)
    Np = xyz_p.shape[1]
    T = Np // w
    half = -(-window // w)
    q_xyz = xyz_p.reshape(B, T, w, 3)
    b_xyz = band_of(q_xyz, half)                       # [B,T,bw,3]
    b_u = band_of(u_p.reshape(B, T, w, C), half)       # [B,T,bw,C]
    d2 = jnp.sum(
        jnp.square(q_xyz[..., :, None, :] - b_xyz[..., None, :, :]),
        axis=-1,
    )                                                  # [B,T,w,bw]
    mask = d2 <= r2
    max_u = jnp.max(
        jnp.where(
            mask[..., None], b_u[..., None, :, :], _NEG.astype(u.dtype)
        ),
        axis=-2,
    )                                                  # [B,T,w,C]
    return max_u.reshape(B, Np, C)[:, :N]


def _banded_max(sorted_xyz, u, radius, window, tile):
    if pooling_engine() == "triton":
        return banded_masked_max(sorted_xyz, u, radius).astype(u.dtype)
    return xla_banded_max(sorted_xyz, u, radius, window, tile)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def banded_max_pool(
    sorted_xyz: jax.Array,
    u: jax.Array,
    radius: float,
    window: int,
    tile: int,
) -> jax.Array:
    """Banded masked max pooling on the engine deepvcp.engine picks.

    On the GPU the Pallas kernels sweep each tile's exact slab (every
    in-radius point); elsewhere the XLA static band of `window` points
    runs. The backward follows from symmetry of the in-radius relation:
    grad_u[n, c] = sum over queries q that see n of g[q, c] *
    [u[n, c] == out[q, c]]. Exact ties receive the full cotangent each
    (measure-zero for float features). Each engine's backward sweeps the
    same neighbourhoods as its forward, so both pairs are consistent."""
    return _banded_max(sorted_xyz, u, radius, window, tile)


def _bmp_fwd(sorted_xyz, u, radius, window, tile):
    out = _banded_max(sorted_xyz, u, radius, window, tile)
    return out, (sorted_xyz, u, out)


def _bmp_bwd(radius, window, tile, res, g):
    sorted_xyz, u, out = res
    # xyz enters only through the piecewise-constant radius mask: zero
    # gradient almost everywhere
    if pooling_engine() == "triton":
        grad_u = banded_masked_max_grad(sorted_xyz, u, out, g, radius)
        return jnp.zeros_like(sorted_xyz), grad_u.astype(u.dtype)
    B, N, _ = sorted_xyz.shape
    C = u.shape[-1]
    w = min(tile, N)
    r2 = jnp.asarray(radius * radius, sorted_xyz.dtype)
    xyz_p = pad_to_tiles(sorted_xyz, w, 1e7)
    g_p = pad_to_tiles(g, w, 0.0)        # padded queries contribute 0
    out_p = pad_to_tiles(out, w, 0.0)
    u_p = pad_to_tiles(u, w, 0.0)
    Np = xyz_p.shape[1]
    T = Np // w
    half = -(-window // w)
    n_xyz = xyz_p.reshape(B, T, w, 3)
    b_xyz = band_of(n_xyz, half)                       # query positions
    b_g = band_of(g_p.reshape(B, T, w, C), half)       # [B,T,bw,C]
    b_out = band_of(out_p.reshape(B, T, w, C), half)   # [B,T,bw,C]
    d2 = jnp.sum(
        jnp.square(n_xyz[..., :, None, :] - b_xyz[..., None, :, :]),
        axis=-1,
    )                                                  # [B,T,w,bw]
    u_n = u_p.reshape(B, T, w, 1, C)
    took = (d2 <= r2)[..., None] & (u_n == b_out[:, :, None, :, :])
    grad_u = jnp.sum(
        jnp.where(took, b_g[:, :, None, :, :], jnp.zeros((), g.dtype)),
        axis=-2,
    ).reshape(B, Np, C)[:, :N]
    return jnp.zeros_like(sorted_xyz), grad_u


banded_max_pool.defvjp(_bmp_fwd, _bmp_bwd)


@dataclasses.dataclass(eq=False)
class BandedSetAbstraction(Module):
    """One banded SA stage: pooled first projection + per-point MLP tail.

    Inputs/outputs in sorted order; npoint == N by construction.
    `window` is the required one-sided slab coverage in points
    (window_for); the band uses ceil(window/tile) tiles per side.
    """

    layer: SALayerConfig
    window: int
    tile: int = 128
    use_batchnorm: bool = True
    axis_name: Optional[str] = None
    dtype: Any = jnp.float32

    def forward(
        self,
        sorted_xyz: jax.Array,
        features: Optional[jax.Array],
        train: bool = False,
    ) -> jax.Array:
        """sorted_xyz [B, N, 3], features [B, N, D] or None ->
        [B, N, mlp[-1]] (sorted order)."""
        cfg = self.layer
        B, N, _ = sorted_xyz.shape
        w = min(self.tile, N)
        dt = self.dtype

        c0 = cfg.mlp[0]
        # per-point projections (the linearity split of the reference's
        # first 1x1 conv over concat(local_xyz, features))
        p = Dense(c0, use_bias=False, dtype=dt, name="proj_xyz")(
            sorted_xyz.astype(dt)
        )
        u = p
        if features is not None:
            u = u + Dense(
                c0, use_bias=False, dtype=dt, name="proj_feat"
            )(features.astype(dt))
        b0 = self.param("bias0", zeros, (c0,), dt)

        # Pair values h0[q, n] = u_n - p_q + b0: the "- p_q + b0" term is
        # constant per query, so max_n h0 = (masked max_n u_n) - p_q + b0.
        # The pair tensor collapses to a select+reduce over the band —
        # nothing per-pair is ever materialized (see banded_max_pool for
        # the engines).
        max_u = banded_max_pool(
            sorted_xyz.astype(dt),
            u,
            float(cfg.radius),
            self.window,
            w,
        )
        pooled = max_u - p + b0
        # relu(max) == max(relu); also rescues the (impossible in practice)
        # empty-neighborhood rows from -inf
        h = relu(pooled)
        return self._mlp_tail(h, train)

    def _mlp_tail(self, h: jax.Array, train: bool) -> jax.Array:
        """Per-point BN + MLP tail (called from within forward)."""
        cfg = self.layer
        dt = self.dtype

        def norm(x, i):
            if not self.use_batchnorm:
                return x
            return BatchNorm(
                use_running_average=not train,
                axis_name=self.axis_name,
                dtype=dt,
                name=f"bn{i}",
            )(x)

        h = norm(h, 0)
        for i, c in enumerate(cfg.mlp[1:], start=1):
            h = Dense(c, dtype=dt, name=f"dense{i}")(h)
            h = relu(norm(h, i))
        return h
