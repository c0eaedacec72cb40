"""Pallas (Triton route) kernels: banded masked max-pool over exact
dynamic slabs, forward and backward.

The inner loop of the banded SA stage (models/fused_sa.py):

    pooled[q, c] = max over n with |x_n - x_q|^2 <= r^2 of u[n, c]

The cloud is sorted along x. The XLA path (fused_sa.xla_banded_max) has
to take a static worst-case band around each tile; at small extents
that band spans the whole cloud twice over. Here each program owns one
tile of `w` queries and one block of `cb` channels, loads its own slab
bounds [lo, lo + n*chunk) from the [B, T] arrays that `_slab_bounds`
computes in XLA (every point whose x lies within r of the tile), and
sweeps the slab with a dynamic-trip loop over `chunk`-point pieces,
keeping the running max in registers. Work is N x slab x C, and the
in-radius set is exact (cap-free), so the result equals the static band
with a window covering the whole cloud.

`banded_masked_max_grad` is the backward: the in-radius relation is
symmetric, so the gradient receivers' slab bounds are the same, and one
program per receiver tile sums the cotangent of every query whose max
it produced:

    grad_u[n, c] = sum_q g[q, c] [d2(n, q) <= r^2] [u[n, c] == out[q, c]]

Each program owns its outputs, so there are no atomics. Exact ties each
receive the full cotangent, as in the XLA indicator sweep.

Features stay row-major [N, C]. Block sizes are powers of two; the live
set of a loop step is [w, chunk, cb] floats, sized for the register
file. Both kernels run on the CPU only when the caller passes
`interpret=True`.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_NEG = -1e30  # plain float: jnp scalars become captured tracers in kernels
_FAR = 1e7    # padding coordinate: never within radius of a real point


def _slab_bounds(key: jax.Array, radius: float, w: int, chunk: int
                 ) -> Tuple[jax.Array, jax.Array]:
    """key [B, Nt] ascending x, Nt a multiple of w. Returns (lo, n) [B, T]
    int32: tile i's slab starts at lo and spans n chunks. lo counts the
    keys below first - r and hi those at most last + r (points at exactly
    r along x are included): one fused compare-and-count over [T, Nt]
    instead of a binary search's dependent gathers."""
    first = key[:, ::w]
    last = key[:, w - 1::w]
    lo = jnp.sum(key[:, None, :] < (first - radius)[:, :, None], axis=-1,
                 dtype=jnp.int32)
    hi = jnp.sum(key[:, None, :] <= (last + radius)[:, :, None], axis=-1,
                 dtype=jnp.int32)
    n = (hi - lo + chunk - 1) // chunk
    return lo.astype(jnp.int32), n.astype(jnp.int32)


def _pad(arrays, N: int, w: int, chunk: int, cb: int):
    """Pad [B, N, *] arrays to Nt = the next multiple of w, plus `chunk`
    rows so that a slab's last chunk never reads past the end; channels
    pad to a multiple of cb. The first array is the cloud (padding at
    _FAR); the rest pad with zeros. Returns (arrays, Nt)."""
    Nt = -(-N // w) * w
    rows = Nt + chunk - N
    out = []
    for j, a in enumerate(arrays):
        cols = 0 if j == 0 else (-a.shape[-1]) % cb
        out.append(jnp.pad(a, [(0, 0), (0, rows), (0, cols)],
                           constant_values=_FAR if j == 0 else 0.0))
    return out, Nt


def _fwd_kernel(lo_ref, n_ref, x_ref, y_ref, z_ref, u_ref, o_ref, *,
                r2, w, chunk, cb):
    b, i, c = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    start = lo_ref[b, i]
    rows = pl.ds(i * w, w)
    qx, qy, qz = x_ref[b, rows], y_ref[b, rows], z_ref[b, rows]    # [w]
    cs = pl.ds(c * cb, cb)

    def body(j, acc):
        for k in range(chunk):      # unrolled: one slab point per step
            p = start + j * chunk + k
            d2 = (jnp.square(qx - x_ref[b, p]) + jnp.square(qy - y_ref[b, p])
                  + jnp.square(qz - z_ref[b, p]))                   # [w]
            acc = jnp.maximum(acc, jnp.where(
                (d2 <= r2)[:, None], u_ref[b, p, cs][None, :], _NEG))
        return acc

    acc = jnp.full((w, cb), _NEG, jnp.float32)
    o_ref[...] = jax.lax.fori_loop(0, n_ref[b, i], body, acc)


def _bwd_kernel(lo_ref, n_ref, x_ref, y_ref, z_ref, u_ref, out_ref, g_ref,
                grad_ref, *, r2, w, chunk, cb):
    b, i, c = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    start = lo_ref[b, i]
    rows = pl.ds(i * w, w)
    px, py, pz = x_ref[b, rows], y_ref[b, rows], z_ref[b, rows]    # [w]
    cs = pl.ds(c * cb, cb)
    nu = u_ref[b, rows, cs]                                        # [w, cb]

    def body(j, acc):
        for k in range(chunk):      # unrolled: one query per step
            q = start + j * chunk + k
            d2 = (jnp.square(px - x_ref[b, q]) + jnp.square(py - y_ref[b, q])
                  + jnp.square(pz - z_ref[b, q]))                   # [w]
            took = (d2 <= r2)[:, None] & (nu == out_ref[b, q, cs][None, :])
            acc = acc + jnp.where(took, g_ref[b, q, cs][None, :], 0.0)
        return acc

    acc = jnp.zeros((w, cb), jnp.float32)
    grad_ref[...] = jax.lax.fori_loop(0, n_ref[b, i], body, acc)


def _call(kernel, name, args, B, Nt, C, w, cb, num_warps, interpret):
    return pl.pallas_call(
        kernel,
        grid=(B, Nt // w, C // cb),
        out_specs=pl.BlockSpec((None, w, cb), lambda b, i, c: (b, i, c)),
        out_shape=jax.ShapeDtypeStruct((B, Nt, C), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name=name,
    )(*args)


def _prepare(sorted_xyz, feats, radius, w, chunk, cb):
    B, N, _ = sorted_xyz.shape
    padded, Nt = _pad([sorted_xyz.astype(jnp.float32)]
                      + [f.astype(jnp.float32) for f in feats],
                      N, w, chunk, cb)
    xyz = padded[0]
    lo, n = _slab_bounds(xyz[:, :Nt, 0], radius, w, chunk)
    coords = [xyz[..., 0], xyz[..., 1], xyz[..., 2]]
    return [lo, n] + coords, padded[1:], Nt


@functools.partial(jax.jit, static_argnames=(
    "radius", "w", "chunk", "cb", "num_warps", "interpret"))
def banded_masked_max(sorted_xyz: jax.Array, u: jax.Array, radius: float,
                      w: int = 32, chunk: int = 16, cb: int = 16,
                      num_warps: int = 1,
                      interpret: bool = False) -> jax.Array:
    """pooled[b, q, c] = max of u[b, n, c] over n with |x_n - x_q| <= r.

    sorted_xyz [B, N, 3] sorted by x, u [B, N, C]. Returns [B, N, C]
    float32; a row with no point in radius (impossible when queries are
    cloud points) holds -1e30."""
    B, N, C = u.shape
    head, (up,), Nt = _prepare(sorted_xyz, [u], radius, w, chunk, cb)
    kernel = functools.partial(_fwd_kernel, r2=float(radius) ** 2, w=w,
                               chunk=chunk, cb=cb)
    out = _call(kernel, "band_max_fwd", head + [up], B, Nt, up.shape[-1], w,
                cb, num_warps, interpret)
    return out[:, :N, :C]


@functools.partial(jax.jit, static_argnames=(
    "radius", "w", "chunk", "cb", "num_warps", "interpret"))
def banded_masked_max_grad(sorted_xyz: jax.Array, u: jax.Array,
                           out: jax.Array, g: jax.Array, radius: float,
                           w: int = 32, chunk: int = 16, cb: int = 16,
                           num_warps: int = 1,
                           interpret: bool = False) -> jax.Array:
    """VJP of banded_masked_max with respect to u.

    sorted_xyz [B, N, 3], u [B, N, C] (forward input), out [B, N, C]
    (forward output), g [B, N, C] (cotangent). Returns grad_u [B, N, C]
    float32."""
    B, N, C = u.shape
    head, (up, op, gp), Nt = _prepare(sorted_xyz, [u, out, g], radius, w,
                                      chunk, cb)
    kernel = functools.partial(_bwd_kernel, r2=float(radius) ** 2, w=w,
                               chunk=chunk, cb=cb)
    grad = _call(kernel, "band_max_bwd", head + [up, op, gp], B, Nt,
                 up.shape[-1], w, cb, num_warps, interpret)
    return grad[:, :N, :C]
