"""Sequence odometry: chained pairwise registration + pose-graph
optimization + trajectory metrics.

Extension beyond the reference (SURVEY.md §7 step 8; BASELINE.json configs
4-5): the reference only registers synthetic pairs. Here, consecutive-frame
relative poses are chained into a trajectory, optional loop-closure /
skip-frame edges form a pose graph, and a Gauss-Newton optimizer (built on
jax, so it jit-compiles and shards) refines the absolute poses. Rotations
are parameterized by so(3) increments (right-multiplicative), translations
directly.

Math: minimize sum over edges (i, j) of
    || log(R_ij_meas^T (R_i^T R_j)) ||^2 + || R_i^T (t_j - t_i) - t_ij ||^2
via damped Gauss-Newton with jax.grad/jacobians on the manifold increments.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# --- SO(3) helpers ----------------------------------------------------------


def hat(w: jax.Array) -> jax.Array:
    """so(3) hat map: [..., 3] -> [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], -1),
            jnp.stack([wz, z, -wx], -1),
            jnp.stack([-wy, wx, z], -1),
        ],
        -2,
    )


def exp_so3(w: jax.Array) -> jax.Array:
    """Rodrigues: [..., 3] -> [..., 3, 3]."""
    theta = jnp.linalg.norm(w, axis=-1, keepdims=True)[..., None]
    K = hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), K.shape)
    safe = jnp.where(theta < 1e-8, 1.0, theta)
    A = jnp.where(theta < 1e-8, 1.0, jnp.sin(safe) / safe)
    B = jnp.where(theta < 1e-8, 0.5, (1.0 - jnp.cos(safe)) / (safe * safe))
    return I + A * K + B * (K @ K)


def log_so3(R: jax.Array) -> jax.Array:
    """[..., 3, 3] -> [..., 3] rotation vector."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = jnp.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = jnp.arccos(cos)
    w = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        -1,
    )
    s = jnp.where(theta < 1e-7, 1.0, 2.0 * jnp.sin(theta))
    scale = jnp.where(theta[..., None] < 1e-7, 0.5, (theta / s)[..., None])
    return w * scale


# --- trajectory assembly ----------------------------------------------------


def chain_poses(
    R_rel: jax.Array, t_rel: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Compose relative poses frame_{i} -> frame_{i+1} into absolute poses.

    Convention: x_{i+1} = R_rel[i] @ x_i + t_rel[i] maps frame i coordinates
    into frame i+1 (the registration direction src=i, tgt=i+1). Absolute
    pose (R_i, t_i) maps frame i into frame 0:
        R_0 = I;  R_{i+1} = R_i @ R_rel[i]^T,
        t_{i+1} = t_i - R_{i+1} @ t_rel[i].

    Args:
        R_rel: [M, 3, 3], t_rel: [M, 3] for M = num_frames - 1.
    Returns:
        (R_abs [M+1, 3, 3], t_abs [M+1, 3]).
    """

    def step(carry, rel):
        R_i, t_i = carry
        Rr, tr = rel
        R_next = R_i @ Rr.T
        t_next = t_i - R_next @ tr
        return (R_next, t_next), (R_next, t_next)

    init = (jnp.eye(3, dtype=R_rel.dtype), jnp.zeros(3, dtype=R_rel.dtype))
    _, (Rs, ts) = jax.lax.scan(step, init, (R_rel, t_rel))
    R_abs = jnp.concatenate([init[0][None], Rs], axis=0)
    t_abs = jnp.concatenate([init[1][None], ts], axis=0)
    return R_abs, t_abs


# --- pose graph -------------------------------------------------------------


class PoseGraph(NamedTuple):
    edges_i: jax.Array   # [E] int32 source node
    edges_j: jax.Array   # [E] int32 target node
    R_meas: jax.Array    # [E, 3, 3] measured R_ij (frame i -> frame j)
    t_meas: jax.Array    # [E, 3]
    weights: jax.Array   # [E] edge confidence


def build_graph(
    R_rel: jax.Array,
    t_rel: jax.Array,
    extra_edges: Optional[Sequence[Tuple[int, int, np.ndarray, np.ndarray]]] = None,
    weights: Optional[jax.Array] = None,
) -> PoseGraph:
    """Sequential odometry edges (i -> i+1) plus optional loop closures.

    Edge measurement convention matches the registration direction:
    x_j = R_meas @ x_i + t_meas.
    """
    M = R_rel.shape[0]
    ei = list(range(M))
    ej = list(range(1, M + 1))
    Rm = [np.asarray(R_rel[k]) for k in range(M)]
    tm = [np.asarray(t_rel[k]) for k in range(M)]
    for (i, j, R_ij, t_ij) in extra_edges or []:
        ei.append(i)
        ej.append(j)
        Rm.append(np.asarray(R_ij))
        tm.append(np.asarray(t_ij))
    E = len(ei)
    w = weights if weights is not None else jnp.ones((E,), jnp.float32)
    return PoseGraph(
        edges_i=jnp.asarray(ei, jnp.int32),
        edges_j=jnp.asarray(ej, jnp.int32),
        R_meas=jnp.asarray(np.stack(Rm), jnp.float32),
        t_meas=jnp.asarray(np.stack(tm), jnp.float32),
        weights=w,
    )


def _edge_residuals(graph: PoseGraph, R_abs: jax.Array, t_abs: jax.Array):
    """Residuals per edge given absolute poses (frame -> world)."""
    Ri = R_abs[graph.edges_i]          # [E,3,3]
    Rj = R_abs[graph.edges_j]
    ti = t_abs[graph.edges_i]
    tj = t_abs[graph.edges_j]
    # predicted relative: x_j = R_ij x_i + t_ij with
    # R_ij = R_j^T R_i, t_ij = R_j^T (t_i - t_j)
    R_pred = jnp.einsum("eba,ebc->eac", Rj, Ri)
    t_pred = jnp.einsum("eba,eb->ea", Rj, ti - tj)
    r_rot = log_so3(
        jnp.einsum("eba,ebc->eac", graph.R_meas, R_pred)
    )                                   # [E,3]
    r_trans = t_pred - graph.t_meas
    w = graph.weights[:, None]
    return r_rot * w, r_trans * w


def optimize_pose_graph(
    graph: PoseGraph,
    R_init: jax.Array,
    t_init: jax.Array,
    num_iters: int = 50,
    lr: float = 0.0,
    damping: float = 1e-3,
    rot_weight: float = 1.0,
) -> Tuple[jax.Array, jax.Array]:
    """Refine absolute poses by damped Gauss-Newton on so(3) x R^3
    increments (node 0 held fixed as gauge). Returns (R_abs, t_abs).

    Implemented as jit-compiled dense normal equations — pose graphs from
    KITTI sequences are small (thousands of nodes), so a dense solve is
    fine on one chip; the Schur-complement distributed variant is the
    multi-host extension point.
    """
    num_nodes = R_init.shape[0]
    dtype = jnp.float32

    def unpack(delta):
        dw = delta[:, :3]
        dt = delta[:, 3:]
        # gauge fix: node 0 pinned
        dw = dw.at[0].set(0.0)
        dt = dt.at[0].set(0.0)
        return dw, dt

    def residual_vec(delta, R_abs, t_abs):
        dw, dt = unpack(delta)
        R_new = R_abs @ exp_so3(dw)
        t_new = t_abs + dt
        r_rot, r_trans = _edge_residuals(graph, R_new, t_new)
        return jnp.concatenate(
            [rot_weight * r_rot.reshape(-1), r_trans.reshape(-1)]
        )

    def gn_step(carry, _):
        R_abs, t_abs = carry
        delta0 = jnp.zeros((num_nodes, 6), dtype)
        J = jax.jacfwd(lambda d: residual_vec(d, R_abs, t_abs))(delta0)
        J = J.reshape(J.shape[0], num_nodes * 6)
        r = residual_vec(delta0, R_abs, t_abs)
        H = J.T @ J + damping * jnp.eye(num_nodes * 6, dtype=dtype)
        g = J.T @ r
        delta = -jnp.linalg.solve(H, g).reshape(num_nodes, 6)
        dw, dt = unpack(delta)
        return (R_abs @ exp_so3(dw), t_abs + dt), None

    (R_out, t_out), _ = jax.lax.scan(
        gn_step, (R_init.astype(dtype), t_init.astype(dtype)),
        None, length=num_iters,
    )
    return R_out, t_out


def optimize_pose_graph_sharded(
    graph: PoseGraph,
    R_init: jax.Array,
    t_init: jax.Array,
    mesh,
    num_iters: int = 20,
    damping: float = 1e-3,
    rot_weight: float = 1.0,
) -> Tuple[jax.Array, jax.Array]:
    """Distributed bundle adjustment: edges sharded over the mesh's "data"
    axis, the normal equations H = sum_e J_e^T J_e and g = sum_e J_e^T r_e
    accumulated with a `psum` collective across the devices, dense
    solve replicated. This is the collective-reduction BA design of
    BASELINE.json configs 4-5 (pose-only graphs need no landmark Schur
    complement; the Schur extension point is the same edge-sharded psum).

    Numerically identical to `optimize_pose_graph` (verified in tests on
    the CPU mesh).
    """
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from deepvcp.parallel.mesh import DATA_AXIS

    num_nodes = R_init.shape[0]
    dtype = jnp.float32
    n_shards = mesh.shape[DATA_AXIS]
    E = graph.edges_i.shape[0]
    pad = (-E) % n_shards
    # pad with zero-weight self-edges (0, 0, identity) — exact no-ops
    def pad_edges(g: PoseGraph) -> PoseGraph:
        if pad == 0:
            return g
        eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (pad, 3, 3))
        return PoseGraph(
            edges_i=jnp.concatenate([g.edges_i, jnp.zeros(pad, jnp.int32)]),
            edges_j=jnp.concatenate([g.edges_j, jnp.zeros(pad, jnp.int32)]),
            R_meas=jnp.concatenate([g.R_meas.astype(dtype), eye]),
            t_meas=jnp.concatenate(
                [g.t_meas.astype(dtype), jnp.zeros((pad, 3), dtype)]
            ),
            weights=jnp.concatenate([g.weights.astype(dtype), jnp.zeros(pad, dtype)]),
        )

    gp = pad_edges(graph)

    def unpack(delta):
        dw = delta[:, :3].at[0].set(0.0)
        dt = delta[:, 3:].at[0].set(0.0)
        return dw, dt

    def shard_residual(delta, R_abs, t_abs, edges):
        ei, ej, Rm, tm, w = edges
        dw, dt = unpack(delta)
        R_new = R_abs @ exp_so3(dw)
        t_new = t_abs + dt
        sub = PoseGraph(ei, ej, Rm, tm, w)
        r_rot, r_trans = _edge_residuals(sub, R_new, t_new)
        return jnp.concatenate(
            [rot_weight * r_rot.reshape(-1), r_trans.reshape(-1)]
        )

    edge_spec = (P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS))

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), edge_spec),
        out_specs=(P(), P()),
    )
    def normal_equations(R_abs, t_abs, edges):
        delta0 = jnp.zeros((num_nodes, 6), dtype)
        J = jax.jacfwd(lambda d: shard_residual(d, R_abs, t_abs, edges))(
            delta0
        ).reshape(-1, num_nodes * 6)
        r = shard_residual(delta0, R_abs, t_abs, edges)
        H_part = J.T @ J
        g_part = J.T @ r
        # the collective: sum partial normal equations over the edge shards
        return (
            jax.lax.psum(H_part, DATA_AXIS),
            jax.lax.psum(g_part, DATA_AXIS),
        )

    edges = (gp.edges_i, gp.edges_j, gp.R_meas, gp.t_meas, gp.weights)

    def gn_step(carry, _):
        R_abs, t_abs = carry
        H, g = normal_equations(R_abs, t_abs, edges)
        H = H + damping * jnp.eye(num_nodes * 6, dtype=dtype)
        delta = -jnp.linalg.solve(H, g).reshape(num_nodes, 6)
        dw, dt = unpack(delta)
        return (R_abs @ exp_so3(dw), t_abs + dt), None

    (R_out, t_out), _ = jax.lax.scan(
        gn_step,
        (R_init.astype(dtype), t_init.astype(dtype)),
        None,
        length=num_iters,
    )
    return R_out, t_out


# --- trajectory metrics -----------------------------------------------------


def absolute_trajectory_error(
    t_pred: jax.Array, t_true: jax.Array, align: bool = True
) -> jax.Array:
    """ATE RMSE over translations; optional SE(3) alignment (Horn) of the
    predicted trajectory to the ground truth, the standard protocol."""
    if align:
        from deepvcp.ops import kabsch, apply_rigid

        R, t = kabsch(t_pred[None], t_true[None])
        t_pred = apply_rigid(t_pred[None], R, t)[0]
    err = jnp.linalg.norm(t_pred - t_true, axis=-1)
    return jnp.sqrt(jnp.mean(err * err))


def relative_pose_errors(
    R_pred: jax.Array, t_pred: jax.Array, R_true: jax.Array, t_true: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Per-edge relative rotation (deg) / translation errors between
    consecutive frames of two absolute trajectories (RPE)."""
    def rel(R, t):
        Ri, Rj = R[:-1], R[1:]
        ti, tj = t[:-1], t[1:]
        R_ij = jnp.einsum("eba,ebc->eac", Rj, Ri)
        t_ij = jnp.einsum("eba,eb->ea", Rj, ti - tj)
        return R_ij, t_ij

    Rp, tp = rel(R_pred, t_pred)
    Rt, tt = rel(R_true, t_true)
    dR = jnp.einsum("eba,ebc->eac", Rp, Rt)
    ang = jnp.degrees(jnp.linalg.norm(log_so3(dR), axis=-1))
    dt = jnp.linalg.norm(tp - tt, axis=-1)
    return ang, dt


# --- landmark bundle adjustment (Schur complement) --------------------------


class LandmarkObs(NamedTuple):
    """Landmark observations: landmark `lm[k]` was seen in frame
    `frame[k]` at coordinates `xyz[k]` (frame-local). The odometry
    pipeline produces these from registered keypoint/VCP matches."""

    frame: jax.Array    # [O] int32 node index
    lm: jax.Array       # [O] int32 landmark index
    xyz: jax.Array      # [O, 3] observed position in frame coordinates
    weights: jax.Array  # [O] confidence


def _ba_normal_equations(
    R_abs, t_abs, landmarks, obs: LandmarkObs, num_nodes: int, num_lm: int
):
    """Per-shard partial normal equations of the landmark residuals
    r = R_f^T (p_l - t_f) - obs  (absolute poses map frame -> world, so
    R_f^T (p - t_f) is the world point in frame coordinates).

    Analytic Jacobians under the same right-multiplicative so(3)
    increment as optimize_pose_graph (R_new = R exp(dw), t_new = t + dt):
        dr/ddw = hat(r0 + obs) ... = hat(R_f^T (p_l - t_f))
        dr/ddt = -R_f^T
        dr/dp  = +R_f^T
    (exp(-dw) y ~ y - dw x y = hat(y) dw for the rotation part).

    Returns (Hpp [N,6,6], Hpl [N*L,6,3], Hll [L,3,3], gp [N,6],
    gl [L,3]) summed over this shard's observations — psum-ready.
    """
    Rf = R_abs[obs.frame]                       # [O, 3, 3]
    tf = t_abs[obs.frame]
    pl = landmarks[obs.lm]                      # [O, 3]
    y = jnp.einsum("oba,ob->oa", Rf, pl - tf)   # R^T (p - t): [O, 3]
    r = y - obs.xyz                             # [O, 3]
    w = obs.weights[:, None, None]

    Jw = hat(y)                                 # [O, 3, 3]
    Jt = -jnp.swapaxes(Rf, -1, -2)              # -R^T
    Jl = jnp.swapaxes(Rf, -1, -2)               # +R^T
    Jp = jnp.concatenate([Jw, Jt], axis=-1)     # [O, 3, 6]

    # weighted blocks; zero-weight (padding) rows vanish exactly
    JpT = jnp.swapaxes(Jp, -1, -2)
    Hpp_o = w * (JpT @ Jp)                      # [O, 6, 6]
    Hll_o = w * (Jl.swapaxes(-1, -2) @ Jl)      # [O, 3, 3]
    Hpl_o = w * (JpT @ Jl)                      # [O, 6, 3]
    gp_o = (w[..., 0] * (JpT @ r[..., None])[..., 0])   # [O, 6]
    gl_o = (w[..., 0] * (Jl.swapaxes(-1, -2) @ r[..., None])[..., 0])

    Hpp = jax.ops.segment_sum(Hpp_o, obs.frame, num_nodes)
    Hll = jax.ops.segment_sum(Hll_o, obs.lm, num_lm)
    Hpl = jax.ops.segment_sum(
        Hpl_o, obs.frame * num_lm + obs.lm, num_nodes * num_lm)
    gp = jax.ops.segment_sum(gp_o, obs.frame, num_nodes)
    gl = jax.ops.segment_sum(gl_o, obs.lm, num_lm)
    return Hpp, Hpl, Hll, gp, gl


def optimize_landmark_ba(
    graph: Optional[PoseGraph],
    R_init: jax.Array,
    t_init: jax.Array,
    landmarks_init: jax.Array,
    obs: LandmarkObs,
    mesh=None,
    num_iters: int = 20,
    damping: float = 1e-3,
    rot_weight: float = 1.0,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Joint pose + landmark bundle adjustment via the Schur complement
    (the reduced camera system) — the multi-host BA named by
    BASELINE.json config 5 and left as the documented extension point of
    `optimize_pose_graph_sharded` until round 5.

    State: N poses (so(3) x R^3 increments, node 0 gauge-fixed) + L
    landmark positions. The landmark block Hll is block-diagonal (3x3
    per landmark), so each Gauss-Newton step solves only the reduced
    [6N, 6N] system:

        S  = Hpp - Hpl Hll^-1 Hlp          (Schur complement)
        S dx_p = -(gp - Hpl Hll^-1 gl)
        dx_l   = -Hll^-1 (gl + Hlp dx_p)   (back-substitution)

    Pose-graph edges (optional `graph`) contribute pose-only terms to
    Hpp/gp through the same jacfwd path as `optimize_pose_graph`, so BA
    refines odometry and structure jointly.

    With `mesh`, observations are sharded over the mesh's "data" axis
    and every partial block (Hpp, Hpl, Hll, gp, gl) is `psum`-reduced —
    the same edge-sharded collective-reduction shape as
    `optimize_pose_graph_sharded`; the dense reduced solve is
    replicated. Numerically identical to the unsharded path (tested on
    the CPU mesh). Memory note: Hpl is materialized as [N*L, 6, 3] —
    fine for keypoint-landmark maps (L ~ 10^3); very large maps would
    shard the landmark axis too.
    """
    num_nodes = R_init.shape[0]
    num_lm = landmarks_init.shape[0]
    dtype = jnp.float32

    def unpack(delta):
        dw = delta[:, :3].at[0].set(0.0)
        dt = delta[:, 3:].at[0].set(0.0)
        return dw, dt

    # optional pose-graph terms, via the same dense jacfwd as
    # optimize_pose_graph (cheap: E small in odometry graphs)
    def graph_terms(R_abs, t_abs):
        if graph is None:
            z6 = jnp.zeros((num_nodes * 6, num_nodes * 6), dtype)
            return z6, jnp.zeros((num_nodes * 6,), dtype)

        def residual_vec(delta):
            dw, dt = unpack(delta)
            r_rot, r_trans = _edge_residuals(
                graph, R_abs @ exp_so3(dw), t_abs + dt)
            return jnp.concatenate(
                [rot_weight * r_rot.reshape(-1), r_trans.reshape(-1)])

        delta0 = jnp.zeros((num_nodes, 6), dtype)
        J = jax.jacfwd(residual_vec)(delta0).reshape(-1, num_nodes * 6)
        r = residual_vec(delta0)
        return J.T @ J, J.T @ r

    if mesh is not None:
        from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P

        from deepvcp.parallel.mesh import DATA_AXIS

        n_shards = mesh.shape[DATA_AXIS]
        O = obs.frame.shape[0]
        pad = (-O) % n_shards
        if pad:
            obs = LandmarkObs(
                frame=jnp.concatenate([obs.frame,
                                       jnp.zeros(pad, jnp.int32)]),
                lm=jnp.concatenate([obs.lm, jnp.zeros(pad, jnp.int32)]),
                xyz=jnp.concatenate([obs.xyz.astype(dtype),
                                     jnp.zeros((pad, 3), dtype)]),
                weights=jnp.concatenate([obs.weights.astype(dtype),
                                         jnp.zeros(pad, dtype)]),
            )
        ospec = LandmarkObs(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
                            P(DATA_AXIS))

        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(P(), P(), P(), ospec), out_specs=(P(),) * 5,
        )
        def sharded_normals(R_abs, t_abs, lms, o):
            parts = _ba_normal_equations(
                R_abs, t_abs, lms, o, num_nodes, num_lm)
            return tuple(jax.lax.psum(p, DATA_AXIS) for p in parts)

        normals = lambda R_abs, t_abs, lms: sharded_normals(
            R_abs, t_abs, lms, obs)
    else:
        normals = lambda R_abs, t_abs, lms: _ba_normal_equations(
            R_abs, t_abs, lms, obs, num_nodes, num_lm)

    eye3 = jnp.eye(3, dtype=dtype)

    def gn_step(carry, _):
        R_abs, t_abs, lms = carry
        Hpp_o, Hpl, Hll, gp, gl = normals(R_abs, t_abs, lms)
        # gauge: node 0 is pinned, so its landmark-term Jacobian blocks
        # are zero by definition (the graph terms already bake this into
        # their residual). Without this the Schur solve distributes
        # increments differently than the gauge-fixed dense system.
        Hpp_o = Hpp_o.at[0].set(0.0)
        gp = gp.at[0].set(0.0)
        Hpl = Hpl.reshape(num_nodes, num_lm, 6, 3).at[0].set(0.0)
        Hg, gg = graph_terms(R_abs, t_abs)
        # assemble pose block: landmark terms (block-diag over frames)
        # + pose-graph terms (dense) + damping
        Hpp = Hg.reshape(num_nodes, 6, num_nodes, 6)
        idx = jnp.arange(num_nodes)
        Hpp = Hpp.at[idx, :, idx, :].add(Hpp_o)
        Hpp = Hpp.reshape(num_nodes * 6, num_nodes * 6)
        Hpp = Hpp + damping * jnp.eye(num_nodes * 6, dtype=dtype)
        g_p = gg + gp.reshape(-1)

        Hll = Hll + damping * eye3                  # [L, 3, 3]
        Hll_inv = jnp.linalg.inv(Hll)
        Hpl_b = Hpl                                 # [N, L, 6, 3]
        # W = Hpl Hll^-1 per (frame, landmark) block
        W = jnp.einsum("nlab,lbc->nlac", Hpl_b, Hll_inv)
        # S = Hpp - sum_l W Hlp
        S_corr = jnp.einsum("nlac,mlbc->namb", W, Hpl_b).reshape(
            num_nodes * 6, num_nodes * 6)
        g_corr = jnp.einsum("nlac,lc->na", W, gl).reshape(-1)
        S = Hpp - S_corr
        rhs = -(g_p - g_corr)
        dxp = jnp.linalg.solve(S, rhs).reshape(num_nodes, 6)
        dw, dt = unpack(dxp)                        # gauge: node 0 pinned
        dxp_fixed = jnp.concatenate([dw, dt], axis=-1)
        # back-substitute landmarks with the gauge-fixed increments
        Hlp_dx = jnp.einsum("nlab,na->lb", Hpl_b, dxp_fixed)
        dxl = -jnp.einsum("lab,lb->la", Hll_inv, gl + Hlp_dx)
        return (R_abs @ exp_so3(dw), t_abs + dt, lms + dxl), None

    (R_out, t_out, lm_out), _ = jax.lax.scan(
        gn_step,
        (R_init.astype(dtype), t_init.astype(dtype),
         landmarks_init.astype(dtype)),
        None, length=num_iters,
    )
    return R_out, t_out, lm_out
