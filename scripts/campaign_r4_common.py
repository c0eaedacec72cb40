"""Shared helpers for the round-4 campaigns (scripts/campaign_r4*.py).

The round-4 question (VERDICT.md "Next round" #1): does RESIDUAL-INIT
training — jittered warm starts, TrainConfig.init_translation="gt" +
init_rot_jitter_deg/init_trans_jitter — produce a model whose GT-free
numbers close the round-3 gap (trained RRE 23.8 deg was WORSE than the
6.7 deg untrained baseline, and refinement diverged)? The mechanism:

- the reference trains on EXACT ground-truth inits (train.py:104-105),
  so (a) any slightly-wrong init at inference is out of distribution
  (measured round-3 Q4 divergence 20.6 -> 54 -> 78 deg), and (b) with
  t_init=0 the true correspondence lies OUTSIDE the candidate grid's
  +/-search_radius reach whenever |t_gt| component exceeds it — the
  reference's own U[-1,1]^3 translations put much of training supervision
  out of reach, saturating the CPG softmax at the grid edge;
- sampling R_init/t_init in a jitter ball AROUND ground truth keeps the
  true VCP in-reach every step and trains the network as a contraction
  of init error — exactly what Registrar(refine_iters>1) iteration needs.

Every phase writes into one summary.json (loaded on restart, so a killed
campaign resumes at the first phase whose key is missing).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


class Campaign:
    """Per-phase persisted summary + resume-aware model training."""

    def __init__(self, name: str):
        self.art = os.path.join(ROOT, "artifacts", name)
        os.makedirs(self.art, exist_ok=True)
        self.summary_path = os.path.join(self.art, "summary.json")
        self.summary: dict = {}
        if os.path.exists(self.summary_path):
            with open(self.summary_path) as fh:
                self.summary = json.load(fh)
            print(f"[{name}] resuming; have {sorted(self.summary)}",
                  flush=True)
        self.name = name

    def done(self, phase: str) -> bool:
        entry = self.summary.get(phase)
        return entry is not None and "error" not in entry

    def save(self, phase: str, payload) -> None:
        self.summary[phase] = payload
        with open(self.summary_path, "w") as fh:
            json.dump(self.summary, fh, indent=2, default=float)
        print(f"[{self.name}] {phase}: "
              f"{json.dumps(payload, default=float)[:600]}", flush=True)


def wait_for_device():
    """Print the devices the campaign runs on."""
    import jax

    print(f"devices: {jax.devices()}", flush=True)


def residual_tcfg(rot_jitter_deg: float = 12.0, trans_jitter: float = 0.5):
    """The round-4 recipe: paper loss terms (direct VCP L1, cosine lr,
    saliency-weighted solve) + the residual warm-start distribution.

    Jitter sizing: held-out small-motion pairs are max 10 deg rotation and
    U[-0.5, 0.5]^3 translation, so an IDENTITY init at inference has
    rotation error <= 10 deg and per-axis translation error <= 0.5 —
    inside the (12 deg, 0.5) training ball. Pass 1 of refinement is
    therefore in-distribution, and later passes see only the contracted
    residual."""
    from deepvcp.config import TrainConfig

    return TrainConfig(
        batch_size=1,
        learning_rate=1e-3,
        vcp_loss_weight=1.0,
        lr_schedule="cosine",
        warmup_steps=100,
        use_saliency_weights=True,
        init_translation="gt",
        init_rot_jitter_deg=rot_jitter_deg,
        init_trans_jitter=trans_jitter,
    )


def make_data(N: int, tiny: bool):
    """The round-3c operating point, kept identical for comparability:
    ModelNet-normalized scale (uniform extent-1 + lidar-like max_range-1
    mix), held-out small-motion (10 deg / 0.5) uniform+lidar sets and a
    full-SO(3) set."""
    from deepvcp.data import LidarLikeDataset, SyntheticDataset

    if tiny:
        n_clouds, n_lidar, held = 4, 2, 2
    else:
        n_clouds, n_lidar, held = 288, 96, 16

    class MixedDataset:
        def __init__(self, parts):
            self.parts = parts

        def __len__(self):
            return sum(len(p) for p in self.parts)

        def sample(self, index, rng):
            a = self.parts[0]
            if index < len(a):
                return a.sample(index, rng)
            return self.parts[1].sample(index - len(a), rng)

    train_ds = MixedDataset((
        SyntheticDataset(num_clouds=n_clouds, num_points=N, extent=1.0,
                         seed=0),
        LidarLikeDataset(num_clouds=n_lidar, num_points=N, max_range=1.0,
                         seed=1),
    ))
    held = {
        "uniform_small": SyntheticDataset(
            num_clouds=held, num_points=N, extent=1.0, seed=100,
            max_rotation_deg=10.0, max_translation=0.5),
        "lidar_small": LidarLikeDataset(
            num_clouds=held, num_points=N, max_range=1.0, seed=101,
            max_rotation_deg=10.0, max_translation=0.5),
        "full_so3": SyntheticDataset(
            num_clouds=held, num_points=N, extent=1.0, seed=102),
    }
    return train_ds, held


def eval_on(eval_step, state, dataset, batches=8):
    """Device-side aggregation; one host sync per dataset."""
    import jax
    import jax.numpy as jnp

    from deepvcp.data import batch_iterator

    agg, n = None, 0
    for src, tgt, R, t in batch_iterator(dataset, 2, epoch=0, seed=777,
                                         shuffle=False):
        m, _ = eval_step(state, jnp.asarray(src), jnp.asarray(tgt),
                         jnp.asarray(R), jnp.asarray(t))
        agg = m if agg is None else jax.tree_util.tree_map(jnp.add, agg, m)
        n += 1
        if n >= batches:
            break
    agg = jax.device_get(agg)
    return {k: round(float(v) / n, 4) for k, v in agg.items()}


def eval_suite(eval_step, state, held, batches=8):
    return {name: eval_on(eval_step, state, ds, batches)
            for name, ds in held.items()}


def registrar_eval(cfg_model, variables, dataset, iters, batches=8,
                   guard=True):
    """GT-free (identity-init) Registrar accuracy at a refine_iters
    setting, with the round-4 non-worsening guard; also reports the mean
    accepted alignment score and how often the guard rejected the final
    iteration's pose."""
    import jax.numpy as jnp
    import numpy as np

    from deepvcp.data import batch_iterator
    from deepvcp.registration import Registrar
    from deepvcp.utils.rotations import rotation_geodesic_deg

    reg = Registrar(cfg_model, variables, use_saliency_weights=True,
                    refine_iters=iters, guard=guard)
    rre = rte = score = rejects = total = 0.0
    n = 0
    for srcb, tgtb, Rb, tb in batch_iterator(dataset, 2, epoch=0, seed=777,
                                             shuffle=False):
        out = reg(jnp.asarray(srcb), jnp.asarray(tgtb))
        rre += float(jnp.mean(rotation_geodesic_deg(out.R, jnp.asarray(Rb))))
        rte += float(jnp.mean(jnp.linalg.norm(out.t - jnp.asarray(tb),
                                              axis=-1)))
        sc = np.asarray(out.scores)                      # [B, iters+1]
        score += float(sc.min(axis=-1).mean())
        rejects += float((sc[:, -1] > sc.min(axis=-1)).sum())
        total += sc.shape[0]
        n += 1
        if n >= batches:
            break
    return {
        "gt_free_rre_deg": round(rre / n, 4),
        "gt_free_rte": round(rte / n, 4),
        "mean_score": round(score / n, 4),
        "last_iter_reject_frac": round(rejects / total, 3),
    }


def train_model(campaign: Campaign, tag, cfg_model, tcfg, epochs,
                train_ds, held, sample, steps_per_epoch,
                init_state=None):
    """Train one model with before/after eval suites; checkpoints +
    metrics land under the campaign dir. init_state warm-starts
    (params, batch_stats) from another trained model (used by the
    fine-grid stage — the CPG convs are grid-size-agnostic, so params
    transfer across search_radius/voxel_len changes)."""
    import time as _time

    import jax.numpy as jnp

    from deepvcp.data import batch_iterator
    from deepvcp.train import Trainer

    tcfg = dataclasses.replace(
        tcfg,
        num_epochs=epochs,
        total_steps=(epochs * steps_per_epoch
                     if tcfg.lr_schedule == "cosine" else 0),
        checkpoint_dir=os.path.join(campaign.art, tag),
        checkpoint_every_epochs=max(epochs // 2, 1),
        metrics_path=os.path.join(campaign.art, f"{tag}_metrics.jsonl"),
        log_every=50,
    )
    tr = Trainer(cfg_model, tcfg)
    tr.setup(sample)
    if init_state is not None:
        # COPY, don't alias: the train step donates its state buffers
        # (donate_argnums), which would delete the source model's params
        # out from under its own Registrar evals
        import jax

        copy = lambda t: jax.tree_util.tree_map(jnp.copy, t)
        tr.state = tr.state.replace(
            params=copy(init_state.params),
            batch_stats=copy(init_state.batch_stats),
        )
    before = eval_suite(tr._eval_step, tr.state, held, batches=4)
    epoch_eval_ds = held.get("uniform_small", next(iter(held.values())))
    t0 = _time.time()
    tr.fit(
        lambda epoch: batch_iterator(train_ds, 1, epoch=epoch, seed=0),
        lambda epoch: batch_iterator(epoch_eval_ds, 2, epoch=0,
                                     seed=777, shuffle=False),
        resume=True,
    )
    after = eval_suite(tr._eval_step, tr.state, held)
    return tr, {
        "random_init" if init_state is None else "init_from": before,
        "trained": after,
        "train_minutes": round((_time.time() - t0) / 60, 1),
        "steps": int(tr.state.step),
    }


def variables_of(trainer):
    return {"params": trainer.state.params,
            "batch_stats": trainer.state.batch_stats}


def load_trained(campaign: Campaign, tag, cfg_model, tcfg, epochs,
                 sample, steps_per_epoch):
    """Rebuild a Trainer and restore the 'final' checkpoint of a phase
    that already ran (restart path)."""
    from deepvcp.train import Trainer

    tcfg = dataclasses.replace(
        tcfg,
        num_epochs=epochs,
        total_steps=(epochs * steps_per_epoch
                     if tcfg.lr_schedule == "cosine" else 0),
        checkpoint_dir=os.path.join(campaign.art, tag),
        metrics_path=os.path.join(campaign.art, f"{tag}_metrics.jsonl"),
    )
    tr = Trainer(cfg_model, tcfg)
    tr.setup(sample)
    tr.load_checkpoint(os.path.join(campaign.art, tag, "final"))
    return tr
