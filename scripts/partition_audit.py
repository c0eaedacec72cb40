"""GSPMD partition audit (VERDICT round-3 weak #10, quantitative leg).

Question: at the real operating point (N=10k, banded FE, ring candidate
KNN), does GSPMD actually PARTITION the program over a
{'data': 4, 'point': 2} mesh — or does it replicate the big
intermediates (the [S, W] neighbor tiles, the [B, KC, ns, 3+F] gathers)
per device?

Method: lower + compile the SAME full train step (B=4) single-device and
on the 8-device forced-CPU mesh, and compare the compiler's own
per-device estimates: `memory_analysis().temp_size_in_bytes` (peak
temporary buffer bytes per device) and `cost_analysis()['flops']`
(per-device program flops). True partitioning shows per-device temp and
flops shrinking by ~the mesh size (modulo collective overhead);
replication shows them flat. Compile-only — nothing is executed, so the
N=10k CPU-fallback OOM documented in dryrun_full_r4.txt does not apply.

Writes artifacts/multichip/partition_audit.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def build_step(mesh, batch_size, num_points):
    from deepvcp import DeepVCPConfig
    from deepvcp.config import TrainConfig
    from deepvcp.models import DeepVCP
    from deepvcp.parallel import shard_batch
    from deepvcp.train.trainer import (
        create_train_state,
        make_train_step,
    )
    from __graft_entry__ import _example_batch

    cfg = DeepVCPConfig(num_points=num_points, use_normal=False,
                        spatial_extent=2.5)
    tcfg = TrainConfig(batch_size=batch_size, metrics_path=None)
    model = DeepVCP(cfg=cfg, knn_mesh=mesh)
    batch = _example_batch(cfg, batch=batch_size)
    state, tx = create_train_state(model, tcfg, batch)
    step = make_train_step(model, tx, tcfg, mesh=mesh)
    if mesh is not None:
        batch = shard_batch(mesh, batch)
    return step, state, batch


def audit(mesh, batch_size, num_points):
    step, state, batch = build_step(mesh, batch_size, num_points)
    t0 = time.time()
    compiled = step.lower(state, *batch).compile()
    mem = compiled.memory_analysis()
    cost = compiled.cost_analysis() or {}
    text = compiled.as_text()
    return {
        "compile_s": round(time.time() - t0, 1),
        "temp_bytes_per_device": int(mem.temp_size_in_bytes),
        "argument_bytes_per_device": int(mem.argument_size_in_bytes),
        "output_bytes_per_device": int(mem.output_size_in_bytes),
        "flops_per_device": float(cost.get("flops", -1)),
        "collectives": {
            op: text.count(op)
            for op in ("all-reduce", "collective-permute", "all-gather",
                       "reduce-scatter")
        },
    }


def main():
    import numpy as np

    from deepvcp.parallel import make_mesh

    N = int(os.environ.get("AUDIT_N", "10000"))
    B = 4
    out = {"num_points": N, "batch": B}

    out["single_device"] = audit(None, B, N)
    print("single:", json.dumps(out["single_device"]), flush=True)

    devices = jax.devices()[:8]
    mesh = make_mesh(devices=devices, point=2)   # {'data': 4, 'point': 2}
    out["mesh_4x2"] = audit(mesh, B, N)
    print("mesh:", json.dumps(out["mesh_4x2"]), flush=True)

    s, m = out["single_device"], out["mesh_4x2"]
    out["per_device_shrink"] = {
        "temp_bytes": round(s["temp_bytes_per_device"]
                            / max(m["temp_bytes_per_device"], 1), 2),
        "flops": round(s["flops_per_device"]
                       / max(m["flops_per_device"], 1.0), 2),
        "ideal": 8.0,
    }
    path = os.path.join(ROOT, "artifacts", "multichip",
                        "partition_audit.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps(out["per_device_shrink"]), flush=True)
    print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    main()
