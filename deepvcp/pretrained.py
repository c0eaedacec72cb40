"""Named pretrained checkpoints from the committed training campaigns.

The reference ships no weights at all (its README tells users to train
from scratch, /root/reference/README.md:1-14; training logs are even
gitignored). This framework commits every campaign checkpoint under
artifacts/, and this module is the supported way to use them:

    from deepvcp import pretrained
    cfg, variables = pretrained.load("modelnet-fine")
    reg = pretrained.registrar("modelnet-fine", refine_iters=3)
    out = reg(src, tgt)

Every entry records the held-out GT-free numbers measured for it (see
artifacts/campaign_r4*/summary.json for the full sweeps). Parameters are
per-point MLP / conv weights, so a checkpoint trained at N=10 000 loads
at any cloud size; `num_points` only sizes the compiled program.

Each registry checkpoint is a numpy archive `<path>.npz` holding params
and batch_stats (deepvcp.utils.checkpoint; scripts/convert_checkpoints.py
made them from the campaigns' orbax directories), read with numpy alone.
Each checkpoint's `.arch.json` provenance
(the D12-D14 semantic flags + grid geometry the model was trained under)
is applied to the returned config, so the weights always compute under
the architecture they were trained with.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Tuple

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fields of the arch fingerprint that map 1:1 onto DeepVCPConfig fields
_ARCH_FIELDS = (
    "centered_grid", "keypoint_selection", "dfe_src_neighbors",
    "derotate_tgt_neighborhoods", "group_radius", "search_radius",
    "voxel_len", "num_keypoints", "num_neighbors", "keypoint_pool_mult",
)

REGISTRY: Dict[str, Dict[str, Any]] = {
    "modelnet-coarse": {
        "path": "artifacts/campaign_r4/model_r1/final",
        "cfg": {"spatial_extent": 2.5},
        "gt_free": {"uniform_small": (2.43, 0.058)},
        "notes": "residual-recipe base model, reference grid "
                 "(r=1.0, s=0.4); best with refine_iters>=2",
    },
    "modelnet-fine": {
        "path": "artifacts/campaign_r4/model_fine/final",
        "cfg": {"spatial_extent": 2.5},
        "gt_free": {"uniform_small": (0.80, 0.026),
                    "lidar_small": (7.47, 0.092)},
        "notes": "fine-grid precision stage (r=0.6, s=0.2) fine-tuned "
                 "from modelnet-coarse; headline ModelNet-scale model, "
                 "refine_iters=3",
    },
    "lidar-fine": {
        "path": "artifacts/campaign_r4c/model_lfine/final",
        "cfg": {"spatial_extent": 2.5},
        "gt_free": {"lidar_small": (2.12, 0.041),
                    "uniform_small": (5.60, 0.31)},
        "notes": "modelnet-fine fine-tuned on a lidar-heavy (25/75) "
                 "mix — the lidar specialist; see README 'lidar gap'",
    },
    "kitti25": {
        "path": "artifacts/campaign_r4b/model_k1/final",
        "cfg": {"spatial_extent": 55.0},
        "gt_free": {"lidar25_small": (0.27, 0.0097)},
        "notes": "velodyne-scale (25 m range, meter coordinates, f32 "
                 "selection gate); use for odometry, refine_iters=2",
    },
    "kitti25-rot": {
        "path": "artifacts/campaign_r5g/model_k7_w3/final",
        "cfg": {"spatial_extent": 55.0},
        "gt_free": {"lidar25_small": (0.2365, 0.0071)},
        "notes": "kitti25 continued with the explicit rotation loss "
                 "term (rot_loss_weight=3) — the ROTATION headline: "
                 "0.24 deg/0.0071 at refine_iters=2, and stable under "
                 "further iteration where kitti25 degraded "
                 "(campaign_r5g E7; rot_weight=10 overshoots). The "
                 "round-5 rotation-wall fix: the point-space loss is "
                 "translation-dominated at 25 m range, so rotation was "
                 "under-supervised",
    },
    "kitti25-fine": {
        "path": "artifacts/campaign_r5/model_k5/final",
        "cfg": {"spatial_extent": 55.0},
        # as cascade stage 2 behind kitti25@2 (campaign_r5 C2 best)
        "gt_free": {"lidar25_small_cascade": (0.384, 0.0064)},
        "notes": "fine-grid KITTI-scale stage (r=0.6, s=0.2 m) trained "
                 "on the cascade hand-off jitter ball (1.5 deg/0.15 m, "
                 "in-reach at the 25 m lever arm); meant as the second "
                 "stage of kitti-cascade, not for identity-init use",
    },
    "kitti25-ultra": {
        "path": "artifacts/campaign_r5/model_k6/final",
        "cfg": {"spatial_extent": 55.0},
        # as cascade stage 3 (campaign_r5 C3 best)
        "gt_free": {"lidar25_small_cascade": (0.447, 0.0027)},
        "notes": "ultra-fine KITTI-scale stage (r=0.3, s=0.1 m, "
                 "0.6 deg/0.07 m ball) — third stage of kitti-cascade",
    },
}

# Multi-stage coarse-to-fine compositions (registration.CascadeRegistrar).
# Stage grids trade reach for resolution; each entry lists
# (registry model, refine_iters) in execution order. Numbers from
# artifacts/campaign_r5/summary.json (C2/C3 sweeps).
CASCADES: Dict[str, Dict[str, Any]] = {
    "kitti-cascade": {
        "stages": [("kitti25", 2), ("kitti25-fine", 1),
                   ("kitti25-ultra", 2)],
        "gt_free": {"lidar25_small": (0.447, 0.0027)},
        "notes": "the RTE-optimal KITTI-scale stack (campaign_r5 C3: "
                 "0.45 deg / 0.0027 m — 26x under the paper's 0.071 m "
                 "bar). Rotation-optimal is kitti25 alone at "
                 "refine_iters=2 (0.27 deg / 0.0097): the trimmed-NN "
                 "guard is rotation-blind below ~0.4 deg at 25 m "
                 "range, so fine stages trade a little rotation for "
                 "3.6x translation (campaign_r5c/e refuted every "
                 "eval-time rotation lever: deeper iteration, more "
                 "keypoints, guard-off all measure WORSE)",
    },
    "modelnet-cascade": {
        "stages": [("modelnet-coarse", 2), ("modelnet-fine", 1)],
        "gt_free": {},
        "notes": "the ModelNet-scale cascade (campaign_r4 part 1 "
                 "measured 1.93 deg/0.025 vs 2.43/0.058 coarse-only)",
    },
}


def available() -> Dict[str, str]:
    """Name -> one-line description of each shipped checkpoint."""
    return {k: v["notes"] for k, v in REGISTRY.items()}


def available_cascades() -> Dict[str, str]:
    """Name -> one-line description of each shipped cascade."""
    return {k: v["notes"] for k, v in CASCADES.items()}


def load(name: str, num_points: int = 10000, use_normal: bool = False
         ) -> Tuple[Any, Dict[str, Any]]:
    """Returns (DeepVCPConfig, variables) for a registry checkpoint.

    variables = {"params": ..., "batch_stats": ...} ready for
    `DeepVCP(cfg=cfg).apply(variables, ...)` or `Registrar(cfg, variables)`.
    """
    from deepvcp.config import DeepVCPConfig

    if name not in REGISTRY:
        raise KeyError(
            f"unknown pretrained model {name!r}; available: "
            f"{sorted(REGISTRY)}")
    entry = REGISTRY[name]
    path = os.path.join(_ROOT, entry["path"])
    if not os.path.exists(path + ".npz"):
        raise FileNotFoundError(
            f"checkpoint for {name!r} not found at {path} — the campaign "
            f"artifacts are committed to the repo; re-run the campaign "
            f"script named in artifacts/{entry['path'].split('/')[1]} to "
            f"regenerate")

    cfg = DeepVCPConfig(num_points=num_points, use_normal=use_normal,
                        **entry["cfg"])
    arch_path = path + ".arch.json"
    if os.path.exists(arch_path):
        with open(arch_path) as fh:
            arch = json.load(fh)
        cfg = dataclasses.replace(
            cfg, **{k: arch[k] for k in _ARCH_FIELDS if k in arch})
        # sa_radii is part of the fingerprint but lives inside the
        # sa_layers tuple rather than as a flat config field (round-4
        # advisor finding: silently dropping it would load a non-default-
        # radii checkpoint under the wrong neighborhoods)
        if "sa_radii" in arch:
            radii = arch["sa_radii"]
            if len(radii) != len(cfg.sa_layers):
                raise ValueError(
                    f"{name!r} provenance records {len(radii)} SA radii "
                    f"but the config has {len(cfg.sa_layers)} SA layers")
            cfg = dataclasses.replace(cfg, sa_layers=tuple(
                dataclasses.replace(l, radius=r)
                for l, r in zip(cfg.sa_layers, radii)))
        # fail loudly on any future fingerprint key this loader doesn't
        # know how to apply (Trainer.load_checkpoint warns on mismatch;
        # this loader applies provenance silently, so an unapplied key
        # would be invisible)
        unapplied = set(arch) - set(_ARCH_FIELDS) - {"sa_radii"}
        if unapplied:
            import warnings

            warnings.warn(
                f"{name!r} arch provenance has keys this loader does not "
                f"apply: {sorted(unapplied)} — the checkpoint may compute "
                f"under mismatched semantics; extend pretrained.load",
                stacklevel=2)

    return cfg, load_variables(path)


def load_variables(path: str) -> Dict[str, Any]:
    """{"params", "batch_stats"} from the checkpoint archive `path.npz`
    (a registry entry, or any Trainer checkpoint: its optimizer state is
    not read). Arch provenance is NOT applied — use load() for registry
    entries, or read `path + ".arch.json"`."""
    from deepvcp.utils.checkpoint import load_nested

    tree = load_nested(path)
    return {"params": tree["params"],
            "batch_stats": tree.get("batch_stats", {})}


def registrar(name: str, num_points: int = 10000, use_normal: bool = False,
              **registrar_kwargs):
    """One-call inference: a ready `Registrar` on a named checkpoint.

    Defaults follow each model's measured best protocol
    (use_saliency_weights on; refine_iters from the registry sweeps can
    be overridden via kwargs)."""
    from deepvcp.registration import Registrar

    cfg, variables = load(name, num_points=num_points,
                          use_normal=use_normal)
    registrar_kwargs.setdefault("use_saliency_weights", True)
    registrar_kwargs.setdefault(
        "refine_iters", 2 if name == "kitti25" else 3)
    return Registrar(cfg, variables, **registrar_kwargs)


def cascade(name: str, num_points: int = 10000, use_normal: bool = False,
            **registrar_kwargs):
    """One-call coarse-to-fine inference: a CascadeRegistrar over a
    named stage composition (see CASCADES). Per-stage refine_iters come
    from the entry; other Registrar kwargs apply to every stage."""
    from deepvcp.registration import CascadeRegistrar, Registrar

    if name not in CASCADES:
        raise KeyError(
            f"unknown cascade {name!r}; available: {sorted(CASCADES)}")
    registrar_kwargs.setdefault("use_saliency_weights", True)
    stages = []
    for stage_name, iters in CASCADES[name]["stages"]:
        cfg, variables = load(stage_name, num_points=num_points,
                              use_normal=use_normal)
        stages.append(Registrar(cfg, variables, refine_iters=iters,
                                **registrar_kwargs))
    return CascadeRegistrar(stages)


def routed_registrar(low: str = "modelnet-fine", high: str = "lidar-fine",
                     num_points: int = 10000, use_normal: bool = False,
                     **registrar_kwargs):
    """Mixture-of-experts inference: route each pair to the specialist
    trained on its density profile (registration.RoutedRegistrar — the
    measured answer to the specialist/generalist trade-off: two 50/50
    fine-tunes landed BETWEEN the specialists on both held sets,
    campaign_r5 G1 / campaign_r5d G2). The experts must share one
    architecture; 'low' serves uniform-density clouds, 'high' serves
    density-gradient (lidar-like) clouds.

    Measured (campaign_r5d G3, held ModelNet-scale protocol, 3 guarded
    refine iters): uniform 0.80 deg / 0.026 AND lidar-like 2.12 deg /
    0.041 — the router recovers each specialist's own numbers
    simultaneously, which no single trained checkpoint achieved."""
    from deepvcp.registration import RoutedRegistrar

    cfg_l, v_l = load(low, num_points=num_points, use_normal=use_normal)
    cfg_h, v_h = load(high, num_points=num_points, use_normal=use_normal)
    if cfg_l != cfg_h:
        raise ValueError(
            f"experts {low!r} and {high!r} have different architectures "
            f"— routing swaps variables under ONE compiled program")
    registrar_kwargs.setdefault("use_saliency_weights", True)
    registrar_kwargs.setdefault("refine_iters", 3)
    return RoutedRegistrar(cfg_l, {"low": v_l, "high": v_h},
                           **registrar_kwargs)
