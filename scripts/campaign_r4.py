"""Round-4 campaign, part 1: the residual-init accuracy story.

Round 3 ended with the accuracy question open (VERDICT.md): the fixed
D12-D14 architecture trained on exact-GT warm starts REGRESSED GT-free
rotation (23.8 deg vs 6.7 untrained) and refinement diverged. The
committed-but-never-trained fix is residual-init training
(TrainConfig.init_*; see scripts/campaign_r4_common.py for the argument).
Phases:

  P0    step-time probe -> epoch budgets;
  R1    fixed defaults (D12-D14 on, topk keypoints), residual recipe;
  R1_sweep   guarded Registrar refine_iters 1/2/3 on all held sets
        (round-3 Q4 rerun: divergence should become monotone improvement);
  R1C   reference-semantics ablation (centered_grid=False,
        dfe_src_neighbors="keypoints", derotate_tgt_neighborhoods=False)
        under the IDENTICAL recipe/budget -> the D12-D14 delta, trained;
  R1S   keypoint_selection="salient_fps" variant -> the lidar fix
        (round-3: trained lidar GT-free RRE was 84 deg with topk);
  DECISION   defaults-vs-ablation on both metrics; topk-vs-salient_fps
        on lidar — written to the summary for the README truth pass;
  FINE  fine-grid refinement stage (search_radius=0.6, voxel_len=0.2 —
        same 3x3x3 CPG convs, so params transfer) fine-tuned from the
        best coarse model with a tighter jitter ball, for a lower
        soft-argmax floor; sweep incl. a coarse->fine cascade.

Artifacts: artifacts/campaign_r4/ (summary.json per phase; checkpoints +
metrics JSONL per model). Restart-safe: completed phases are skipped.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from campaign_r4_common import (  # noqa: E402
    Campaign,
    eval_suite,
    load_trained,
    make_data,
    registrar_eval,
    residual_tcfg,
    train_model,
    variables_of,
    wait_for_device,
)


def main():
    import jax

    TINY = os.environ.get("CAMPAIGN_TINY") == "1"
    if TINY:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from deepvcp import DeepVCPConfig
    from deepvcp.data import batch_iterator
    from deepvcp.train import Trainer

    wait_for_device()
    c = Campaign("campaign_r4")

    if TINY:
        N = 128
        cfg_fixed = dataclasses.replace(
            DeepVCPConfig.tiny(num_points=N, use_normal=False),
            neighbor_method="banded", spatial_extent=4.0, band_tile=64,
        )
        BUDGET = {"R1": 0.2, "R1C": 0.2, "R1S": 0.2, "FINE": 0.2}
    else:
        N = 10000
        cfg_fixed = DeepVCPConfig(
            num_points=N, use_normal=False, spatial_extent=2.5
        )
        BUDGET = {"R1": 35.0, "R1C": 25.0, "R1S": 25.0, "FINE": 15.0}

    cfg_ref_sem = dataclasses.replace(
        cfg_fixed,
        centered_grid=False,
        dfe_src_neighbors="keypoints",
        derotate_tgt_neighborhoods=False,
    )
    cfg_sfps = dataclasses.replace(cfg_fixed, keypoint_selection="salient_fps")

    train_ds, held = make_data(N, TINY)
    steps_per_epoch = len(train_ds)
    sample = next(batch_iterator(train_ds, 1, epoch=0, seed=0))
    tcfg = residual_tcfg()

    # ---- P0: probe step time, size the budgets -----------------------------
    if not c.done("P0_step_probe"):
        import time

        probe = Trainer(cfg_fixed, dataclasses.replace(
            tcfg, num_epochs=1, total_steps=steps_per_epoch,
            metrics_path=os.path.join(c.art, "probe.jsonl"),
            checkpoint_dir=os.path.join(c.art, "probe_ck"),
        ))
        probe.setup(sample)
        src, tgt, R, t = (jnp.asarray(a) for a in sample)
        st = probe.state
        st, m = probe._train_step(st, src, tgt, R, t)
        float(m["loss"])
        t0 = time.time()
        for _ in range(10):
            st, m = probe._train_step(st, src, tgt, R, t)
        float(m["loss"])
        step_ms = (time.time() - t0) / 10 * 1e3
        del st, probe
        c.save("P0_step_probe", {"residual_step_ms": round(step_ms, 2),
                                 "steps_per_epoch": steps_per_epoch})
    step_ms = c.summary["P0_step_probe"]["residual_step_ms"]

    def epochs_for(budget_min):
        steps = max(int(budget_min * 60e3 / step_ms), steps_per_epoch)
        return max(min(steps // steps_per_epoch, 60), 1)

    # ---- R1: fixed architecture, residual recipe ----------------------------
    trainers = {}

    def model_phase(phase, tag, cfg_model, tcfg_model, budget_key,
                    init_state=None):
        epochs = epochs_for(BUDGET[budget_key])
        if c.done(phase):
            trainers[tag] = load_trained(
                c, tag, cfg_model, tcfg_model, epochs, sample,
                steps_per_epoch)
            return
        try:
            tr, res = train_model(
                c, tag, cfg_model, tcfg_model, epochs, train_ds, held,
                sample, steps_per_epoch, init_state=init_state)
            trainers[tag] = tr
            c.save(phase, res)
        except Exception:
            c.save(phase, {"error": traceback.format_exc()})

    def sweep_phase(phase, tag, cfg_model, iters_list=(1, 2, 3),
                    sets=("uniform_small", "lidar_small", "full_so3")):
        if c.done(phase) or tag not in trainers:
            return
        try:
            variables = variables_of(trainers[tag])
            sweep = {}
            for iters in iters_list:
                sweep[f"iters_{iters}"] = {
                    name: registrar_eval(cfg_model, variables, held[name],
                                         iters, batches=8)
                    for name in sets
                }
            c.save(phase, sweep)
        except Exception:
            c.save(phase, {"error": traceback.format_exc()})

    model_phase("R1_fixed_arch_residual", "model_r1", cfg_fixed, tcfg, "R1")
    sweep_phase("R1_sweep", "model_r1", cfg_fixed)

    model_phase("R1C_reference_semantics_ablation", "model_r1c",
                cfg_ref_sem, tcfg, "R1C")
    sweep_phase("R1C_sweep", "model_r1c", cfg_ref_sem,
                sets=("uniform_small",))

    model_phase("R1S_salient_fps", "model_r1s", cfg_sfps, tcfg, "R1S")
    sweep_phase("R1S_sweep", "model_r1s", cfg_sfps,
                sets=("uniform_small", "lidar_small"))

    # ---- DECISION: what the numbers say the defaults should be -------------
    # (recomputed every run: it is pure bookkeeping over the sweeps, and a
    # resumed run may have filled in a sweep a previous run lacked)
    if True:
        try:
            def best(sweep_key, set_name):
                sweep = c.summary.get(sweep_key, {})
                rows = [v[set_name] for k, v in sweep.items()
                        if k.startswith("iters_") and set_name in v]
                if not rows:
                    return None
                return min(rows, key=lambda r: (r["gt_free_rre_deg"]
                                                + 10 * r["gt_free_rte"]))

            r1_u = best("R1_sweep", "uniform_small")
            r1c_u = best("R1C_sweep", "uniform_small")
            r1_l = best("R1_sweep", "lidar_small")
            r1s_l = best("R1S_sweep", "lidar_small")
            dec = {
                "fixed_defaults_uniform": r1_u,
                "reference_semantics_uniform": r1c_u,
                "fixed_beats_ablation_both_metrics": (
                    r1_u is not None and r1c_u is not None
                    and r1_u["gt_free_rre_deg"] <= r1c_u["gt_free_rre_deg"]
                    and r1_u["gt_free_rte"] <= r1c_u["gt_free_rte"]),
                "topk_lidar": r1_l,
                "salient_fps_lidar": r1s_l,
                "salient_fps_wins_lidar": (
                    r1_l is not None and r1s_l is not None
                    and r1s_l["gt_free_rre_deg"] < r1_l["gt_free_rre_deg"]),
            }
            c.save("DECISION", dec)
        except Exception:
            c.save("DECISION", {"error": traceback.format_exc()})

    # ---- FINE: fine-grid refinement stage -----------------------------------
    # Same candidate COUNT scaling (7^3=343 vs 6^3=216) but 2x finer voxel
    # pitch: the CPG soft-argmax floor scales with voxel_len, so the fine
    # model is the precision stage; its reach (0.7 per axis incl. the
    # half-voxel margin) still covers the held-out identity-init error
    # (<= 0.5 trans + <= 0.17 keypoint displacement at 10 deg).
    # pin FINE's provenance across resumes: once trained, the source
    # model and keypoint policy come from the saved entry, not from a
    # DECISION that may have changed since (e.g. R1S filled in later)
    fine_entry = c.summary.get("FINE_grid_finetune", {})
    if "fine_src" in fine_entry:
        fine_src = fine_entry["fine_src"]
    else:
        fine_src = ("model_r1s" if c.summary.get("DECISION", {}).get(
            "salient_fps_wins_lidar") else "model_r1")
    cfg_fine = dataclasses.replace(
        cfg_sfps if fine_src == "model_r1s" else cfg_fixed,
        search_radius=0.6 if not TINY else cfg_fixed.search_radius,
        voxel_len=0.2 if not TINY else cfg_fixed.voxel_len,
    )
    tcfg_fine = dataclasses.replace(
        tcfg, init_rot_jitter_deg=8.0, init_trans_jitter=0.35)
    if fine_src in trainers:
        model_phase("FINE_grid_finetune", "model_fine", cfg_fine, tcfg_fine,
                    "FINE", init_state=trainers[fine_src].state)
        entry = c.summary.get("FINE_grid_finetune")
        if entry is not None and "error" not in entry \
                and "fine_src" not in entry:
            entry["fine_src"] = fine_src
            entry["keypoint_selection"] = cfg_fine.keypoint_selection
            c.save("FINE_grid_finetune", entry)
        sweep_phase("FINE_sweep", "model_fine", cfg_fine,
                    sets=("uniform_small", "lidar_small"))

    # coarse->fine cascade: one coarse pass (R1) then the fine model
    if not c.done("CASCADE") and fine_src in trainers \
            and "model_fine" in trainers:
        try:
            from deepvcp.registration import Registrar
            from deepvcp.utils.rotations import rotation_geodesic_deg

            coarse = Registrar(
                cfg_fixed if fine_src == "model_r1" else cfg_sfps,
                variables_of(trainers[fine_src]),
                use_saliency_weights=True, refine_iters=1)
            fine = Registrar(cfg_fine, variables_of(trainers["model_fine"]),
                             use_saliency_weights=True, refine_iters=2)
            out = {}
            for name in ("uniform_small", "lidar_small"):
                rre = rte = n = 0.0
                for srcb, tgtb, Rb, tb in batch_iterator(
                        held[name], 2, epoch=0, seed=777, shuffle=False):
                    srcb, tgtb = jnp.asarray(srcb), jnp.asarray(tgtb)
                    o1 = coarse(srcb, tgtb)
                    o2 = fine(srcb, tgtb, R_init=o1.R, t_init=o1.t)
                    rre += float(jnp.mean(rotation_geodesic_deg(
                        o2.R, jnp.asarray(Rb))))
                    rte += float(jnp.mean(jnp.linalg.norm(
                        o2.t - jnp.asarray(tb), axis=-1)))
                    n += 1
                    if n >= 8:
                        break
                out[name] = {"gt_free_rre_deg": round(rre / n, 4),
                             "gt_free_rte": round(rte / n, 4)}
            c.save("CASCADE", out)
        except Exception:
            c.save("CASCADE", {"error": traceback.format_exc()})

    print("[campaign_r4] DONE", flush=True)


if __name__ == "__main__":
    main()
