"""Smoke test of the system's main path on the GPU, in one process.

    python chip_smoke.py          # one card: the phases below
    python chip_smoke.py --four   # four cards: the mesh phases only

One card, N=10 000-point clouds, registry checkpoints:

  band_max      the pooling kernels compiled for the card against the XLA
                static band with a window covering the whole cloud, at
                extents 2.5 and 55 and the SA stages' widths C=16/32/64:
                the max bit for bit, the gradient to atol 1e-5 plus rtol
                1e-5 (sums over hundreds of queries taken in another
                order than XLA's);
  kitti25       pretrained.registrar("kitti25") on 8 lidar-like pairs of
                at most 5 deg / 0.5 m (the README protocol); K=64, C=216,
                ns=32;
  kitti-cascade pretrained.cascade("kitti-cascade") on the same pairs;
  modelnet-fine pretrained.registrar("modelnet-fine") at extent 2.5 on 8
                uniform pairs of at most 10 deg / 0.5 m;
  highest       kitti25 as served against the same checkpoint under
                Precision.HIGHEST with exact candidate selection;
  train         three steps of make_train_step at kitti scale, B=2;
  so3_init      one initializer.so3_global_init on a pair rotated by an
                unrestricted rotation.

Four cards: one data-parallel train step on a data=4 mesh against the
same step on one card, and ring KNN on a point=4 mesh against exact KNN.

Each phase prints its compile time, steady-state time, the compiled
program's memory analysis and its checks. Any failed check raises, so
the script exits non-zero and prints no result. The last line is
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

N = 10000

# Accuracy bounds on the median over the pairs. The registry recorded its
# numbers under approximate selection and exact-slab pooling; the GPU's
# selection is exact, which campaign T1 measured at 0.40 deg for kitti25
# (README). The bounds sit well above that and well below identity init
# (about 2.5 deg / 0.25 m median on these pairs).
BOUNDS = {
    "kitti25": (1.0, 0.05),
    "kitti-cascade": (1.0, 0.05),
    "modelnet-fine": (3.0, 0.1),    # T1: 1.85 deg under exact selection
}
# Served kitti25 against the HIGHEST-precision exact-selection reference.
# Default-precision f32 matmuls run in TF32 on the card (10-bit
# mantissa), so features differ in the fourth digit. That moves poses by
# round-off only until a discrete choice flips: a keypoint at the top-K
# boundary, a trimmed inlier, or the guard's accept/reject of a refine
# iteration. A flip moves the pose by up to one refinement step, which is
# of the order of the pose's own error (kitti25 median RTE ~5 mm on these
# pairs, 9.7 mm in the registry). The tolerance allows one such step and
# no more: twice the registry's RTE, and a tenth of a degree.
HIGHEST_TOL = (0.1, 0.02)           # deg, m
SO3_BOUND_DEG = 15.0                # the cascade's basin is a few deg;
                                    # a failed sweep lands ~random


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


def timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def median_s(fn, *args, n=5):
    import numpy as np

    return float(np.median([timed(fn, *args)[1] for _ in range(n)]))


def memory(compiled) -> dict:
    m = compiled.memory_analysis()
    return {k: getattr(m, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}


def pairs(kind: str, count: int, seed: int, **kw):
    import jax.numpy as jnp

    from deepvcp.data import LidarLikeDataset, SyntheticDataset, \
        batch_iterator

    if kind == "lidar":
        ds = LidarLikeDataset(num_clouds=count, num_points=N, seed=seed,
                              max_range=25.0, **kw)
    else:
        ds = SyntheticDataset(num_clouds=count, num_points=N, seed=seed,
                              extent=1.0, **kw)
    return [tuple(jnp.asarray(a) for a in b)
            for b in batch_iterator(ds, 1, shuffle=False)]


def pose_errors(outs, data):
    import numpy as np

    from deepvcp.utils import rotation_geodesic_deg, translation_error

    rre = [float(rotation_geodesic_deg(o.R, d[2])[0]) for o, d in
           zip(outs, data)]
    rte = [float(translation_error(o.t, d[3])[0]) for o, d in
           zip(outs, data)]
    return float(np.median(rre)), float(np.median(rte)), rre, rte


def rotation_diff_deg(Ra, Rb) -> float:
    """The angle between two rotations from their Frobenius distance, in
    float64: the arccos of the trace resolves only ~0.02 deg in float32."""
    import numpy as np

    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb,
                                                                np.float64))
    return float(np.degrees(2.0 * np.arcsin(min(d / np.sqrt(8.0), 1.0))))


def phase_band_max():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from deepvcp.data.datasets import lidar_like_cloud
    from deepvcp.models.fused_sa import xla_banded_max
    from deepvcp.ops.pallas import banded_masked_max, banded_masked_max_grad

    # The reference band holds 2 * ceil(window / tile) + 1 tiles: with
    # window N/2 that is more than the cloud's N/tile tiles, so it covers
    # the whole cloud (exact in-radius semantics). A point the torus
    # roll brings in twice is one value twice: the max is unchanged and
    # autodiff splits its cotangent between the copies, which sum back.
    window, tile = N // 2, 256
    rng = np.random.default_rng(0)
    for extent in (2.5, 55.0):
        xyz = (rng.uniform(-1, 1, (N, 3)) if extent < 10
               else lidar_like_cloud(rng, N, max_range=25.0))
        xyz = jnp.asarray(xyz[np.argsort(xyz[:, 0])][None]
                          .astype(np.float32))
        for r, C in ((0.1, 16), (0.2, 32), (0.4, 64)):
            # Features without ties: the kernels give each tied maximum
            # the full cotangent, XLA's max gradient splits it between
            # them, and f32 normal draws repeat a few values per column.
            u = jnp.asarray(rng.permutation(N * C).reshape(1, N, C)
                            .astype(np.float32) - N * C / 2)
            g = jnp.asarray(rng.standard_normal((1, N, C)).astype(np.float32))
            out, t_fwd = timed(lambda x, v: banded_masked_max(x, v, r), xyz, u)
            ref = jax.jit(lambda x, v: xla_banded_max(x, v, r, window, tile))(
                xyz, u)
            grad, t_bwd = timed(
                lambda x, v, o, c: banded_masked_max_grad(x, v, o, c, r),
                xyz, u, out, g)
            ref_grad = np.asarray(jax.jit(lambda v, c: jax.vjp(
                lambda vv: xla_banded_max(xyz, vv, r, window, tile), v)[1](
                    c)[0])(u, g))
            n_diff = int(np.sum(np.asarray(out) != np.asarray(ref)))
            gdiff = float(np.max(np.abs(np.asarray(grad) - ref_grad)))
            grad_ok = bool(np.allclose(np.asarray(grad), ref_grad,
                                       atol=1e-5, rtol=1e-5))
            log("band_max", extent=extent, radius=r, C=C,
                first_fwd_s=t_fwd, first_bwd_s=t_bwd,
                fwd_ms=1e3 * median_s(
                    lambda x, v: banded_masked_max(x, v, r), xyz, u),
                bwd_ms=1e3 * median_s(
                    lambda x, v, o, c: banded_masked_max_grad(
                        x, v, o, c, r), xyz, u, out, g),
                max_values_differing=n_diff, grad_max_abs_diff=gdiff)
            check(n_diff == 0, f"band max bit-identical (extent {extent}, "
                               f"C {C}): {n_diff} values differ")
            check(grad_ok, f"band max gradient (extent {extent}, C {C})")


def run_registrar(name, reg, data, stages=None):
    """Compile, time and score one registrar over the pairs."""
    from deepvcp import pretrained

    src, tgt = data[0][0], data[0][1]
    _, first = timed(lambda: reg(src, tgt).R)
    mem = [memory(s.lower(src, tgt).compile())
           for s in (stages or [reg])]
    outs = [reg(d[0], d[1]) for d in data]
    steady = median_s(lambda: reg(src, tgt).R)
    rre, rte, all_rre, all_rte = pose_errors(outs, data)
    entry = (pretrained.CASCADES.get(name) or pretrained.REGISTRY[name])
    recorded = list(entry["gt_free"].items())[0]
    log(name, compile_and_first_call_s=first, steady_ms=1e3 * steady,
        memory=mem, median_rre_deg=rre, median_rte_m=rte,
        rre_deg=all_rre, rte_m=all_rte, bounds=BOUNDS[name],
        registry_gt_free={recorded[0]: recorded[1]})
    check(rre <= BOUNDS[name][0] and rte <= BOUNDS[name][1],
          f"{name} median RRE {rre:.3f} deg / RTE {rte:.4f} m within "
          f"{BOUNDS[name]}")
    return outs


def phase_registration():
    import jax
    import numpy as np

    from deepvcp import pretrained
    from deepvcp.registration import Registrar

    lidar = pairs("lidar", 8, seed=7, max_rotation_deg=5.0,
                  max_translation=0.5)
    reg = pretrained.registrar("kitti25", num_points=N)
    served = run_registrar("kitti25", reg, lidar)
    # Registrar.stream keeps calls in flight; the extent monitor's host
    # callback runs inside every call, so a stream that waited on it
    # would take as long per pair as calls made one at a time.
    _, one_at_a_time = timed(lambda: [jax.block_until_ready(reg(*d[:2]))
                                      for d in lidar])
    _, streamed = timed(lambda: list(reg.stream([d[:2] for d in lidar])))
    log("stream", pairs=len(lidar), one_at_a_time_ms_per_pair=1e3 *
        one_at_a_time / len(lidar), stream_ms_per_pair=1e3 * streamed /
        len(lidar))

    casc = pretrained.cascade("kitti-cascade", num_points=N)
    run_registrar("kitti-cascade", casc, lidar, stages=casc.stages)

    uniform = pairs("uniform", 8, seed=8, max_rotation_deg=10.0,
                    max_translation=0.5)
    run_registrar("modelnet-fine",
                  pretrained.registrar("modelnet-fine", num_points=N),
                  uniform)

    exact = Registrar(dataclasses.replace(reg.cfg, candidate_knn="exact"),
                      reg.variables, use_saliency_weights=True,
                      refine_iters=reg.refine_iters)
    with jax.default_matmul_precision("highest"):
        ref = [exact(d[0], d[1]) for d in lidar]
    drot = [rotation_diff_deg(a.R, b.R) for a, b in zip(served, ref)]
    dt = [float(np.linalg.norm(np.asarray(a.t - b.t)))
          for a, b in zip(served, ref)]

    def same(field, a, b):
        return bool(np.array_equal(np.asarray(getattr(a, field)),
                                   np.asarray(getattr(b, field))))

    ref_rre, ref_rte, _, _ = pose_errors(ref, lidar)
    log("highest", rot_diff_deg=drot, trans_diff_m=dt, tolerance=HIGHEST_TOL,
        reference_median_rre_deg=ref_rre, reference_median_rte_m=ref_rte,
        same_keypoints=[same("keypoints", a, b) for a, b in zip(served, ref)],
        same_inliers=[same("inlier_idx", a, b) for a, b in zip(served, ref)],
        same_accepted_iteration=[
            bool(np.array_equal(np.argmin(np.asarray(a.scores), -1),
                                np.argmin(np.asarray(b.scores), -1)))
            for a, b in zip(served, ref)])
    check(max(drot) <= HIGHEST_TOL[0] and max(dt) <= HIGHEST_TOL[1],
          f"kitti25 served vs HIGHEST/exact: max {max(drot):.4f} deg, "
          f"{max(dt):.5f} m within {HIGHEST_TOL}")


def phase_train():
    import jax
    import numpy as np

    from deepvcp import DeepVCPConfig
    from deepvcp.config import TrainConfig
    from deepvcp.data import LidarLikeDataset, batch_iterator
    from deepvcp.models import DeepVCP
    from deepvcp.train.trainer import create_train_state, make_train_step

    ds = LidarLikeDataset(num_clouds=6, num_points=N, max_range=25.0,
                          seed=9, max_rotation_deg=5.0, max_translation=0.5)
    batches = list(batch_iterator(ds, 2, shuffle=False))
    model = DeepVCP(cfg=DeepVCPConfig.kitti_scale(N))
    tcfg = TrainConfig(batch_size=2)
    state, tx = create_train_state(model, tcfg, batches[0])
    step = make_train_step(model, tx, tcfg)
    before = [np.asarray(p) for p in jax.tree_util.tree_leaves(state.params)]
    losses, times = [], []
    for b in batches:
        (state, metrics), dt = timed(step, state, *b)
        losses.append(float(metrics["loss"]))
        times.append(dt)
    after = [np.asarray(p) for p in jax.tree_util.tree_leaves(state.params)]
    mem = memory(step.lower(state, *batches[0]).compile())
    changed = sum(not np.array_equal(a, b) for a, b in zip(before, after))
    log("train", compile_and_first_step_s=times[0],
        steady_ms=1e3 * float(np.median(times[1:])), memory=mem,
        losses=losses, param_leaves_changed=changed,
        param_leaves=len(before))
    check(all(np.isfinite(losses)), f"finite losses {losses}")
    check(changed > 0, "the params changed")


def phase_so3_init():
    import numpy as np

    from deepvcp.initializer import so3_global_init
    from deepvcp.utils import rotation_geodesic_deg, translation_error

    (src, tgt, R, t), = pairs("lidar", 1, seed=11, max_rotation_deg=None,
                              max_translation=1.0)
    init, first = timed(so3_global_init, src, tgt)
    steady = median_s(so3_global_init, src, tgt, n=3)
    mem = memory(so3_global_init.lower(src, tgt).compile())
    rre = float(rotation_geodesic_deg(init.R, R)[0])
    rte = float(translation_error(init.t, t)[0])
    ortho = float(np.max(np.abs(
        np.asarray(init.R[0] @ init.R[0].T) - np.eye(3))))
    log("so3_init", compile_and_first_call_s=first, steady_ms=1e3 * steady,
        memory=mem, true_rotation_deg=float(rotation_geodesic_deg(
            R, np.eye(3, dtype=np.float32)[None])[0]),
        rre_deg=rre, rte_m=rte, orthonormality_err=ortho)
    check(np.isfinite(rte) and ortho < 1e-4, "a finite rigid pose")
    check(rre <= SO3_BOUND_DEG, f"init RRE {rre:.2f} deg <= {SO3_BOUND_DEG}")


def phase_data_parallel():
    import jax
    import numpy as np
    import optax

    from deepvcp import DeepVCPConfig
    from deepvcp.config import TrainConfig
    from deepvcp.data import LidarLikeDataset, batch_iterator
    from deepvcp.models import DeepVCP
    from deepvcp.parallel.mesh import make_mesh, shard_batch
    from deepvcp.train.trainer import create_train_state, make_train_step

    ds = LidarLikeDataset(num_clouds=4, num_points=N, max_range=25.0,
                          seed=12, max_rotation_deg=5.0, max_translation=0.5)
    batch = next(batch_iterator(ds, 4, shuffle=False))
    model = DeepVCP(cfg=DeepVCPConfig.kitti_scale(N))
    tcfg = TrainConfig(batch_size=4)
    mesh = make_mesh(jax.devices()[:4], data=4, point=1)
    # The step runs with plain SGD at learning rate 1, so the updated
    # params are params - gradient and expose the gradient itself. (Adam's
    # first step moves each weight by lr * g / (|g| + eps): where the true
    # gradient is zero, as for a bias ahead of a BatchNorm, g is round-off
    # whose sign follows the summation order, and the two programs move
    # that weight by up to lr in opposite directions.)
    sgd = optax.sgd(1.0)
    results = {}
    with jax.default_matmul_precision("highest"):
        for kind in ("one", "mesh"):
            state, _ = create_train_state(model, tcfg, batch)
            state = state.replace(opt_state=sgd.init(state.params))
            before = [np.asarray(p, np.float64)
                      for p in jax.tree_util.tree_leaves(state.params)]
            if kind == "one":
                step = make_train_step(model, sgd, tcfg)
                args = batch
            else:
                step = make_train_step(model, sgd, tcfg, mesh)
                args = shard_batch(mesh, batch)
            (new, metrics), first = timed(step, state, *args)
            results[kind] = (
                float(metrics["loss"]), float(metrics["grad_norm"]),
                [b - np.asarray(p, np.float64) for b, p in zip(
                    before, jax.tree_util.tree_leaves(new.params))])
            times = []
            for _ in range(3):
                (new, _), dt = timed(step, new, *args)
                times.append(dt)
            log("data_parallel", kind=kind, compile_and_first_step_s=first,
                steady_ms=1e3 * float(np.median(times)),
                loss=results[kind][0], grad_norm=results[kind][1])
    (l1, n1, g1), (l4, n4, g4) = results["one"], results["mesh"]
    gmax = max(float(np.max(np.abs(g))) for g in g1)
    gdiff = max(float(np.max(np.abs(a - b))) for a, b in zip(g1, g4))
    log("data_parallel", loss_rel_diff=abs(l1 - l4) / abs(l1),
        grad_norm_rel_diff=abs(n1 - n4) / n1, grad_max_abs=gmax,
        grad_max_abs_diff=gdiff)
    # The two programs sum the batch in another order, so they agree to
    # f32 round-off: the loss and gradient norm to 1e-5 relative, every
    # gradient entry (read from the updated params, which adds the
    # params' own rounding) to 1e-4 of the largest. A wrong all-reduce
    # (a missing shard, a sum for a mean) is off by O(1).
    check(abs(l1 - l4) <= 1e-5 * abs(l1), "data=4 loss equals one card's")
    check(abs(n1 - n4) <= 1e-5 * n1, "data=4 gradient norm equals one's")
    check(gdiff <= 1e-4 * gmax,
          "data=4 updated params (gradient) equal one card's")


def phase_ring_knn():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from deepvcp import ops
    from deepvcp.data.datasets import lidar_like_cloud
    from deepvcp.ops.distributed import ring_knn
    from deepvcp.parallel.mesh import make_mesh

    rng = np.random.default_rng(13)
    ref = jnp.asarray(lidar_like_cloud(rng, N, max_range=25.0)[None]
                      .astype(np.float32))
    kp = ref[:, rng.choice(N, 64, replace=False)]
    query = ops.voxelize(kp, 1.0, 0.4).reshape(1, -1, 3)     # [1, 13824, 3]
    mesh = make_mesh(jax.devices()[:4], data=1, point=4)
    (d_ring, i_ring), first = timed(
        jax.jit(lambda r, q: ring_knn(mesh, r, q, 32)), ref, query)
    d_ref, i_ref = jax.jit(lambda r, q: ops.knn(r, q, 32))(ref, query)
    i_ring, i_ref = np.asarray(i_ring), np.asarray(i_ref)
    d_ring, d_ref = np.asarray(d_ring), np.asarray(d_ref)
    rows = ~np.all(np.sort(i_ring, -1) == np.sort(i_ref, -1), axis=-1)
    # a differing row is a tie: the same distances, a different index at
    # the k-th place
    ties = np.allclose(d_ring[rows], d_ref[rows], rtol=1e-6, atol=1e-6)
    log("ring_knn", queries=int(query.shape[1]), k=32,
        compile_and_first_call_s=first, rows_differing=int(rows.sum()),
        differing_rows_are_ties=bool(ties),
        max_dist_diff=float(np.max(np.abs(d_ring - d_ref))))
    check(ties, "ring KNN equals exact KNN except for ties")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run the four-card mesh phases only")
    args = p.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke needs a GPU; JAX found {dev.platform}")
    count = 4 if args.four else 1
    if len(jax.devices()) < count:
        sys.exit(f"needs {count} GPUs, JAX sees {len(jax.devices())}")

    from deepvcp.utils.cache import enable_compile_cache
    from deepvcp.utils.device import card_name_and_power_limit

    enable_compile_cache()
    print(card_name_and_power_limit(), flush=True)
    phases = ((phase_data_parallel, phase_ring_knn) if args.four else
              (phase_band_max, phase_registration, phase_train,
               phase_so3_init))
    t0 = time.perf_counter()
    for phase in phases:
        phase()
    log("done", total_s=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
