"""Per-stage latency + FLOP/byte roofline report of the registration
pipeline on the GPU.

Capability parity with the reference's ad-hoc per-stage wall-clock prints
(deepVCP.py:28-98), but measured properly: each stage is AOT-compiled ONCE
(the same executable is timed and asked for the compiler's cost analysis),
warmed up, timed as a stream of calls ending in block_until_ready, and
scored against the device's published peaks (FLOPs + device-memory bytes)
— naming which stages are compute-, bandwidth-, or overhead-bound. This
workload is gather/selection-bound by design, so raw FLOP utilization is
expected to be low; the per-stage bound classification is the actionable
output.

    python -m deepvcp.profile_stages --num-points 10000 [--batch B]
"""

from __future__ import annotations

import argparse
import json
import time

# Published peaks by jax device_kind. Source: NVIDIA's H100 SXM data
# sheet (dense, without sparsity, at the full 700 W power limit; a card
# set below it cannot hold its top clock under load). "flops" is the
# tensor cores' TF32 rate, which f32 matmuls at default precision use;
# "bytes" is the device-memory bandwidth.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 495e12, "bytes": 3.35e12},
}


def device_peaks(device_kind: str) -> dict:
    """The PEAKS entry for `device_kind`; an unknown device is an error."""
    if device_kind not in PEAKS:
        raise KeyError(
            f"no published peaks for device {device_kind!r}; add its data "
            f"sheet rates to PEAKS (known: {sorted(PEAKS)})")
    return PEAKS[device_kind]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-points", type=int, default=10000)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--reps", type=int, default=10,
                   help="calls per timed stream (pipelined; one sync)")
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)

    import jax

    from deepvcp.utils.cache import enable_compile_cache

    enable_compile_cache()
    peaks = device_peaks(jax.devices()[0].device_kind)

    import jax.numpy as jnp
    import numpy as np

    from deepvcp import DeepVCPConfig
    from deepvcp.loss.registration import svd_refine
    from deepvcp.models import DeepVCP, FeatureExtraction
    from deepvcp.models.layers import CPG, FeatEmbedding, WeightingLayer
    from deepvcp.ops import voxelize
    from deepvcp.ops.grouping import index_points
    from deepvcp.ops.knn import approx_knn
    from deepvcp.ops.two_level import two_level_rows

    cfg = (
        DeepVCPConfig.tiny(args.num_points, use_normal=False)
        if args.tiny
        else DeepVCPConfig(num_points=args.num_points, use_normal=False)
    )
    B = args.batch
    rng = np.random.default_rng(0)
    src = jnp.asarray(
        rng.uniform(-10, 10, (B, cfg.num_points, 3)).astype(np.float32)
    )
    tgt = jnp.asarray(
        rng.uniform(-10, 10, (B, cfg.num_points, 3)).astype(np.float32)
    )
    model = DeepVCP(cfg=cfg)
    variables = jax.jit(model.init, static_argnames=("train",))(
        jax.random.key(0), src, tgt,
        jnp.broadcast_to(jnp.eye(3), (B, 3, 3)), jnp.zeros((B, 3)),
        train=False,
    )
    params = variables["params"]
    K, ns, C = cfg.num_keypoints, cfg.num_neighbors, cfg.num_candidates
    F = cfg.feat_dim

    fe = FeatureExtraction(cfg, name="fe")
    wl = WeightingLayer(cfg.wl_mlp, name="wl")
    dfe = FeatEmbedding(cfg.dfe_mlp, activation=cfg.dfe_activation, name="dfe")
    cpg = CPG(cfg.cpg_channels, grid_size=cfg.grid_size, name="cpg")

    # representative synthetic inputs per stage (values don't change the
    # schedules; shapes/dtypes do)
    feats = jnp.asarray(
        rng.standard_normal((B, cfg.num_points, F)).astype(np.float32)
    )
    kp = src[:, :K]
    cand = voxelize(kp, cfg.search_radius, cfg.voxel_len)   # [B,K,C,3]
    cand_flat = cand.reshape(B, K * C, 3)
    src_cat = jnp.asarray(
        rng.standard_normal((B, K, ns, 3 + F)).astype(np.float32)
    )
    tgt_cat = jnp.asarray(
        rng.standard_normal((B, K, C, ns, 3 + F)).astype(np.float32)
    )
    src_desc = jnp.asarray(
        rng.standard_normal((B, K, F)).astype(np.float32)
    )
    tgt_desc = jnp.asarray(
        rng.standard_normal((B, K, C, F)).astype(np.float32)
    )
    vcp = kp + 0.1 * jnp.asarray(
        rng.standard_normal((B, K, 3)).astype(np.float32)
    )

    stages = {
        "fe(src)": (
            lambda x: fe.apply(
                {"params": params["fe"],
                 "batch_stats": variables["batch_stats"].get("fe", {})},
                x, None, train=False),
            (src,),
        ),
        "fe(tgt)": (
            lambda x: fe.apply(
                {"params": params["fe"],
                 "batch_stats": variables["batch_stats"].get("fe", {})},
                x, None, train=False),
            (tgt,),
        ),
        "weighting": (
            lambda f: wl.apply({"params": params["wl"]}, f), (feats,)
        ),
        "candidate knn": (
            lambda t_, q_: approx_knn(
                t_, q_, ns, chunk=cfg.knn_query_chunk,
                select_dtype=cfg.knn_select_dtype_effective,
            ),
            (tgt, cand_flat),
        ),
        # flat-path fused neighbor-row gather (the [K*C*ns]-row random
        # gather the two-level path replaces)
        "row gather": (
            lambda r_, i_: index_points(r_, i_),
            (
                jnp.concatenate([tgt, feats], axis=-1),
                jnp.asarray(rng.integers(
                    0, cfg.num_points, (B, K * C, ns)).astype(np.int32)),
            ),
        ),
        # two-level replacement for candidate knn + row gather
        # (ops/two_level.py: per-keypoint table, local-coordinate
        # selection, table row gather)
        "two-level rows": (
            lambda t_, r_, k_, c_: two_level_rows(
                t_, r_, k_, c_, ns,
                table_size=cfg.tgt_knn_table,
                select_dtype=cfg.knn_select_dtype,
                center_select_dtype=cfg.knn_select_dtype_effective,
            ),
            (tgt, jnp.concatenate([tgt, feats], axis=-1), kp, cand),
        ),
        "dfe(src)": (
            lambda x: dfe.apply({"params": params["dfe"]}, x), (src_cat,)
        ),
        "dfe(tgt)": (
            lambda x: dfe.apply({"params": params["dfe"]}, x), (tgt_cat,)
        ),
        "cpg": (
            lambda s, t_, c: cpg.apply({"params": params["cpg"]}, s, t_, c),
            (src_desc, tgt_desc, cand),
        ),
        "svd solve": (lambda x, y: svd_refine(x, y)[:2], (kp, vcp)),
    }

    # Each stage is timed as a stream of `reps` back-to-back dispatches
    # ending in block_until_ready, so host dispatch overlaps the device;
    # the best of `iters` streams is divided by reps.
    def stream_time(compiled, a):
        t_best = None
        for _ in range(args.iters):
            t0 = time.perf_counter()
            out = None
            for _ in range(args.reps):
                out = compiled(*a)
            jax.block_until_ready(out)
            dt = time.perf_counter() - t0
            t_best = dt if t_best is None else min(t_best, dt)
        return t_best

    best = {}
    costs = {}
    for name, (fn, a) in stages.items():
        compiled = jax.jit(fn).lower(*a).compile()
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        if ca:
            costs[name] = {
                "flops": float(ca.get("flops", 0.0)),
                "bytes": float(ca.get("bytes accessed", 0.0)),
            }
        jax.block_until_ready(compiled(*a))  # warm-up
        best[name] = stream_time(compiled, a) / args.reps

    total = sum(best.values())
    lines = [f"{'stage':16s} {'ms':>8s} {'%':>6s} {'GFLOP':>9s} {'GB':>8s}"
             f" {'TFLOP/s':>8s} {'GB/s':>7s} {'%flops':>7s} {'%bw':>6s}  bound"]
    table = {}
    for name, sec in best.items():
        ms = sec * 1e3
        pct = 100.0 * sec / total if total else 0.0
        cost = costs.get(name)
        if cost is None:
            lines.append(f"{name:16s} {ms:8.2f} {pct:6.1f}")
            continue
        tflops = cost["flops"] / sec / 1e12
        gbs = cost["bytes"] / sec / 1e9
        pf = 100.0 * cost["flops"] / sec / peaks["flops"]
        pb = 100.0 * cost["bytes"] / sec / peaks["bytes"]
        bound = (
            "compute" if pf >= max(pb, 5.0)
            else "bandwidth" if pb >= 5.0
            else "overhead"
        )
        lines.append(
            f"{name:16s} {ms:8.2f} {pct:6.1f} {cost['flops']/1e9:9.2f}"
            f" {cost['bytes']/1e9:8.3f} {tflops:8.2f} {gbs:7.1f}"
            f" {pf:7.2f} {pb:6.1f}  {bound}"
        )
        table[name] = {
            "ms": round(ms, 3),
            "gflop": round(cost["flops"] / 1e9, 3),
            "gb": round(cost["bytes"] / 1e9, 4),
            "pct_peak_flops": round(pf, 3),
            "pct_peak_bw": round(pb, 2),
            "bound": bound,
        }
    lines.append(f"{'total':16s} {total*1e3:8.2f}")
    print("\n".join(lines))
    print(json.dumps({
        "device_kind": jax.devices()[0].device_kind,
        "batch": B,
        "stages_ms": {k: v * 1e3 for k, v in best.items()},
        "roofline": table,
    }))


if __name__ == "__main__":
    main()
