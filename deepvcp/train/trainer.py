"""Training driver (L6 replacement; ref train.py:36-170).

A jitted train step (forward + two-pass SVD loss + Adam update + exact
global BatchNorm statistics) sharded over a `jax.sharding.Mesh`:

- the batch of frame pairs is sharded over the "data" mesh axis (the
  replacement for the reference's single-host nn.DataParallel,
  train.py:75-78); XLA inserts the gradient all-reduce;
- parameters and optimizer state are replicated;
- checkpoints are .npz archives of the whole state (params + opt state +
  step, keyed by tree path; epoch cadence parity with train.py:135-143),
  metrics to JSONL.

As in the reference (train.py:104-105), the model is warm-started with
R_init = R_gt and t_init = 0 during training.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from deepvcp.config import DeepVCPConfig, TrainConfig
from deepvcp.loss import deepvcp_loss
from deepvcp.models import DeepVCP
from deepvcp.train.metrics import MetricsLogger
from deepvcp.utils import rotation_geodesic_deg, translation_error
from deepvcp.utils.checkpoint import load_into, save_tree


class TrainState(NamedTuple):
    params: Any
    batch_stats: Any
    opt_state: Any
    step: jax.Array

    def replace(self, **fields) -> "TrainState":
        return self._replace(**fields)


def create_train_state(
    model: DeepVCP,
    cfg: TrainConfig,
    sample_batch: Tuple[np.ndarray, ...],
    rng: Optional[jax.Array] = None,
) -> Tuple[TrainState, optax.GradientTransformation]:
    src, tgt, R, t = (jnp.asarray(a[:1]) for a in sample_batch)
    rng = rng if rng is not None else jax.random.key(cfg.seed)
    variables = model.init(rng, src, tgt, R, jnp.zeros_like(t), train=False)
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    if cfg.lr_schedule == "cosine":
        if cfg.total_steps <= 0:
            raise ValueError("lr_schedule='cosine' requires total_steps > 0")
        warmup = min(cfg.warmup_steps, max(cfg.total_steps // 10, 1))
        lr = optax.warmup_cosine_decay_schedule(
            init_value=0.0,
            peak_value=cfg.learning_rate,
            warmup_steps=warmup,
            decay_steps=cfg.total_steps,
            end_value=cfg.learning_rate * 0.01,
        )
    elif cfg.lr_schedule == "constant":
        lr = cfg.learning_rate
    else:
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if cfg.grad_clip_norm > 0:
        tx = optax.chain(
            optax.clip_by_global_norm(cfg.grad_clip_norm),
            optax.adam(lr),
        )
    else:
        tx = optax.adam(lr)
    opt_state = tx.init(params)
    return (
        TrainState(
            params=params,
            batch_stats=batch_stats,
            opt_state=opt_state,
            step=jnp.zeros((), jnp.int32),
        ),
        tx,
    )


def _train_init_pose(cfg: TrainConfig, step, R_gt, t_gt):
    """The warm-start pose fed to the model during training.

    Reference parity (defaults): (R_gt, 0) — ref train.py:104-105.
    Residual mode (init_translation="gt" and/or jitter > 0): a pose
    sampled around ground truth, so the network learns to CONTRACT init
    error instead of only ever seeing exact inits (see TrainConfig).
    The key is derived from (seed, step): deterministic, resume-stable,
    and traced-friendly (step is the on-device step counter)."""
    if cfg.init_translation not in ("zero", "gt"):
        raise ValueError(
            f"init_translation must be 'zero' or 'gt', got "
            f"{cfg.init_translation!r}"
        )
    B = t_gt.shape[0]
    t_init = t_gt if cfg.init_translation == "gt" else jnp.zeros_like(t_gt)
    if cfg.init_rot_jitter_deg <= 0 and cfg.init_trans_jitter <= 0:
        return R_gt, t_init
    from deepvcp.utils.rotations import random_small_rotation

    key = jax.random.fold_in(jax.random.key(cfg.seed ^ 0x5EED), step)
    k_rot, k_t = jax.random.split(key)
    R_init = R_gt
    if cfg.init_rot_jitter_deg > 0:
        dR = random_small_rotation(
            k_rot, B, jnp.radians(cfg.init_rot_jitter_deg)
        ).astype(R_gt.dtype)
        R_init = dR @ R_gt
    if cfg.init_trans_jitter > 0:
        t_init = t_init + jax.random.uniform(
            k_t, t_gt.shape, t_gt.dtype,
            minval=-cfg.init_trans_jitter, maxval=cfg.init_trans_jitter,
        )
    return R_init, t_init


def build_train_step(model: DeepVCP, tx, cfg: TrainConfig):
    """The raw (unjitted) train step: state, src, tgt, R_gt, t_gt ->
    (new_state, metrics)."""

    def loss_fn(params, batch_stats, src, tgt, R_gt, t_gt, step):
        variables = {"params": params, "batch_stats": batch_stats}
        R_init, t_init = _train_init_pose(cfg, step, R_gt, t_gt)
        if cfg.freeze_batch_stats:
            # fine-tune mode: BatchNorm consumes the checkpoint's
            # RUNNING statistics and never updates them (train=False
            # only gates BN here — there is no dropout). Round-5
            # finding (campaigns r5i/r5j): LONG fine-tune continuations
            # at B=1 drift the running stats away from the train-time
            # batch statistics — train metrics stay healthy while eval
            # vcp_l1 diverges ~10x mid-schedule — and cosine decay only
            # partially recovers it. Freezing removes the drift channel.
            kp, vcp, aux = model.apply(
                variables, src, tgt, R_init, t_init, train=False)
            updates = {"batch_stats": batch_stats}
        else:
            (kp, vcp, aux), updates = model.apply(
                variables,
                src,
                tgt,
                R_init,
                t_init,
                train=True,
                mutable=["batch_stats"],
            )
        weights = (
            aux["keypoint_saliency"] if cfg.use_saliency_weights else None
        )
        res = deepvcp_loss(
            kp, vcp, R_gt, t_gt, alpha=cfg.alpha,
            inlier_ratio=cfg.inlier_ratio, weights=weights,
            vcp_weight=cfg.vcp_loss_weight,
            rot_weight=cfg.rot_loss_weight,
        )
        return res.loss, (res, updates["batch_stats"])

    def train_step(state: TrainState, src, tgt, R_gt, t_gt):
        (loss, (res, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(state.params, state.batch_stats, src, tgt, R_gt, t_gt, state.step)
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        metrics = {
            "loss": loss,
            "l1": res.l1,
            "mean_residual": res.mean_residual,
            "vcp_l1": res.vcp_l1,
            "rre_deg": jnp.mean(rotation_geodesic_deg(res.R, R_gt)),
            "rte": jnp.mean(translation_error(res.t, t_gt)),
            "grad_norm": optax.global_norm(grads),
        }
        new_state = TrainState(
            params=new_params,
            batch_stats=new_stats,
            opt_state=new_opt,
            step=state.step + 1,
        )
        return new_state, metrics

    return train_step


def make_train_step(model: DeepVCP, tx, cfg: TrainConfig, mesh=None):
    """Jit the train step; with a mesh, shard the batch over ("data",
    "point") and replicate the state (see parallel/mesh.py)."""
    step = build_train_step(model, tx, cfg)
    if mesh is None:
        return jax.jit(step, donate_argnums=(0,))
    from deepvcp.parallel.mesh import batch_pair_sharding, replicated

    rep = replicated(mesh)
    return jax.jit(
        step,
        in_shardings=(rep,) + batch_pair_sharding(mesh),
        out_shardings=(rep, rep),
        donate_argnums=(0,),
    )


def make_eval_step(model: DeepVCP, cfg: TrainConfig):
    """Eval reports TWO operating points per batch:

    - warm-started (R_init = R_gt, like training and ref train.py:104-105):
      `rre_deg`/`rte` — measures correspondence quality given the pose;
    - GT-free (identity init + the unsupervised svd_refine solver, the
      Registrar inference path): `gt_free_rre_deg`/`gt_free_rte` — the
      honest capability number. For full-SO(3) pairs this is expected to be
      poor (the candidate grid only reaches ~search_radius around the
      un-warmed keypoints); on small-motion pairs it is the headline metric.
    """
    from deepvcp.loss.registration import svd_refine

    def eval_step(state: TrainState, src, tgt, R_gt, t_gt):
        variables = {"params": state.params, "batch_stats": state.batch_stats}
        # warm init matches the training distribution's CENTER: (R_gt, 0)
        # in reference-parity mode, (R_gt, t_gt) in residual mode (where
        # the fine grid is not sized to span the full translation range)
        t_warm = (t_gt if cfg.init_translation == "gt"
                  else jnp.zeros_like(t_gt))
        kp, vcp, aux = model.apply(
            variables, src, tgt, R_gt, t_warm, train=False
        )
        # SAME objective as training (incl. the vcp term and saliency
        # weights) so train/eval losses are comparable; RRE/RTE are
        # objective-independent (review finding)
        res = deepvcp_loss(
            kp, vcp, R_gt, t_gt, alpha=cfg.alpha,
            inlier_ratio=cfg.inlier_ratio,
            weights=(aux["keypoint_saliency"]
                     if cfg.use_saliency_weights else None),
            vcp_weight=cfg.vcp_loss_weight,
            rot_weight=cfg.rot_loss_weight,
        )
        B = src.shape[0]
        eye = jnp.broadcast_to(jnp.eye(3, dtype=src.dtype), (B, 3, 3))
        kp0, vcp0, _ = model.apply(
            variables, src, tgt, eye, jnp.zeros_like(t_gt), train=False
        )
        free = svd_refine(kp0, vcp0, cfg.inlier_ratio)
        return {
            "loss": res.loss,
            "vcp_l1": res.vcp_l1,
            "rre_deg": jnp.mean(rotation_geodesic_deg(res.R, R_gt)),
            "rte": jnp.mean(translation_error(res.t, t_gt)),
            "gt_free_rre_deg": jnp.mean(
                rotation_geodesic_deg(free.R, R_gt)
            ),
            "gt_free_rte": jnp.mean(translation_error(free.t, t_gt)),
        }, (res.R, res.t)

    return jax.jit(eval_step)


class Trainer:
    """Epoch loop with checkpointing and metrics (ref train.py:92-170)."""

    def __init__(
        self,
        model_cfg: DeepVCPConfig,
        train_cfg: TrainConfig,
        metrics: Optional[MetricsLogger] = None,
    ):
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.model = DeepVCP(cfg=model_cfg)
        self.metrics = metrics or MetricsLogger(train_cfg.metrics_path)
        self.state: Optional[TrainState] = None
        self._train_step = None
        self._eval_step = None
        self._tx = None

    # -- checkpointing ------------------------------------------------------
    def save_checkpoint(self, tag: str, epoch: Optional[int] = None) -> str:
        """Write the state to `<checkpoint_dir>/<tag>.npz` and its
        provenance to `<tag>.arch.json`; returns the path without the
        suffix, which load_checkpoint takes."""
        import json

        path = os.path.abspath(os.path.join(self.cfg.checkpoint_dir, tag))
        save_tree(path, self.state)
        # architecture provenance (review finding): the D12-D14 semantic
        # flags change the forward WITHOUT changing parameter shapes, so a
        # checkpoint trained under one setting restores cleanly into a
        # model running another and silently degrades. Record the
        # shape-compatible semantics-affecting fields next to the
        # checkpoint; load_checkpoint warns on mismatch.
        with open(path + ".arch.json", "w") as fh:
            json.dump(self._arch_fingerprint(), fh)
        # resume marker for elastic restarts (SURVEY.md §5 failure
        # detection: the reference's closest capability is manual
        # --retrain_path, train.py:83-85). Only epoch-tagged saves update
        # it — ad-hoc saves (e.g. the final model alias) must not clobber
        # the resume point.
        if epoch is not None:
            marker = os.path.join(
                os.path.abspath(self.cfg.checkpoint_dir), "latest.json"
            )
            with open(marker, "w") as fh:
                json.dump(
                    {"tag": tag, "epoch": epoch, "step": int(self.state.step)},
                    fh,
                )
        return path

    def latest_checkpoint(self) -> Optional[dict]:
        """The resume marker written by save_checkpoint, or None."""
        import json

        marker = os.path.join(
            os.path.abspath(self.cfg.checkpoint_dir), "latest.json"
        )
        if not os.path.exists(marker):
            return None
        with open(marker) as fh:
            info = json.load(fh)
        info["path"] = os.path.join(
            os.path.abspath(self.cfg.checkpoint_dir), info["tag"]
        )
        return info

    def _arch_fingerprint(self) -> dict:
        """The model-config fields that alter forward semantics while
        keeping the parameter tree shape-compatible (everything else —
        channel widths, layer counts — fails loudly at restore)."""
        c = self.model_cfg
        return {
            "centered_grid": c.centered_grid,
            "keypoint_selection": c.keypoint_selection,
            "dfe_src_neighbors": c.dfe_src_neighbors,
            "derotate_tgt_neighborhoods": c.derotate_tgt_neighborhoods,
            "group_radius": c.group_radius,
            "search_radius": c.search_radius,
            "voxel_len": c.voxel_len,
            # these change the forward without changing parameter shapes
            # too (round-3 advisor finding): K/ns alter every grouping
            # stage, pool_mult alters salient-FPS selection, and the SA
            # radii alter every neighborhood the convs see
            "num_keypoints": c.num_keypoints,
            "num_neighbors": c.num_neighbors,
            "keypoint_pool_mult": c.keypoint_pool_mult,
            "sa_radii": [l.radius for l in c.sa_layers],
        }

    def load_checkpoint(self, path: str) -> None:
        import json
        import warnings

        arch_path = os.path.abspath(path) + ".arch.json"
        if os.path.exists(arch_path):
            with open(arch_path) as fh:
                saved = json.load(fh)
            cur = self._arch_fingerprint()
            diff = {k: (saved.get(k), cur[k]) for k in cur
                    if saved.get(k) != cur[k]}
            if diff:
                warnings.warn(
                    f"checkpoint {path} was trained under different forward "
                    f"semantics (saved vs current): {diff} — the parameter "
                    f"shapes match but the weights will compute under a "
                    f"mismatched architecture. Set the listed DeepVCPConfig "
                    f"fields to the saved values to restore faithfully.",
                    stacklevel=2,
                )
        else:
            warnings.warn(
                f"checkpoint {path} has no architecture provenance "
                f"({os.path.basename(arch_path)} missing) — it may predate "
                f"the D12-D14 semantic flags (centered_grid, "
                f"dfe_src_neighbors, derotate_tgt_neighborhoods), whose "
                f"current defaults differ from reference semantics.",
                stacklevel=2,
            )
        restored = load_into(os.path.abspath(path), self.state)
        self.state = jax.tree_util.tree_map(jnp.asarray, restored)

    # -- loops --------------------------------------------------------------
    def setup(self, sample_batch, retrain_path: Optional[str] = None) -> None:
        self.state, self._tx = create_train_state(
            self.model, self.cfg, sample_batch
        )
        self._train_step = make_train_step(self.model, self._tx, self.cfg)
        self._eval_step = make_eval_step(self.model, self.cfg)
        if retrain_path:
            self.load_checkpoint(retrain_path)

    def train_epoch(self, batches: Iterator, epoch: int) -> Dict[str, float]:
        """One epoch. Metrics stay ON DEVICE between log points: each
        float() waits for the device and copies to the host, so the
        running sum is a device-side tree and the host only syncs every
        `log_every` steps plus once at epoch end."""
        agg = None
        n = 0
        for i, (src, tgt, R, t) in enumerate(batches):
            self.state, m = self._train_step(
                self.state,
                jnp.asarray(src),
                jnp.asarray(tgt),
                jnp.asarray(R),
                jnp.asarray(t),
            )
            agg = (
                m
                if agg is None
                else jax.tree_util.tree_map(jnp.add, agg, m)
            )
            n += 1
            if (i + 1) % self.cfg.log_every == 0:
                host_m = {k: float(v) for k, v in m.items()}
                self.metrics.log(
                    {"kind": "train", "epoch": epoch, "batch": i, **host_m}
                )
        if agg is None:
            return {}
        agg = jax.device_get(agg)
        return {k: float(v) / max(n, 1) for k, v in agg.items()}

    def evaluate(self, batches: Iterator, epoch: int = -1) -> Dict[str, float]:
        """Held-out eval pass. Like train_epoch, the running metric sum is
        a device-side tree and the host syncs ONCE at the end instead of
        once per batch and key."""
        agg = None
        n = 0
        for src, tgt, R, t in batches:
            m, _ = self._eval_step(
                self.state,
                jnp.asarray(src),
                jnp.asarray(tgt),
                jnp.asarray(R),
                jnp.asarray(t),
            )
            agg = (
                m
                if agg is None
                else jax.tree_util.tree_map(jnp.add, agg, m)
            )
            n += 1
        if agg is None:
            return {}
        agg = jax.device_get(agg)
        out = {k: float(v) / max(n, 1) for k, v in agg.items()}
        self.metrics.log({"kind": "eval", "epoch": epoch, **out})
        return out

    def fit(
        self, make_train_batches, make_eval_batches=None, resume: bool = False
    ) -> None:
        """make_train_batches(epoch) -> iterator of (src, tgt, R, t).

        With resume=True, restart from the latest checkpoint marker in
        checkpoint_dir (elastic recovery: a killed run continues at the
        next epoch with identical data order, since batches are seeded
        per epoch).

        With cfg.heartbeat_interval > 0 the loop also runs the
        multi-host failure detector (parallel/heartbeat.py): heartbeat
        + startup barrier + per-epoch watchdog scan, so a dead or
        wedged peer fails this process loudly instead of hanging in a
        collective; the restarted job resumes here via resume=True."""
        start_epoch = 0
        if resume:
            info = self.latest_checkpoint()
            if info is not None and info.get("epoch") is not None:
                self.load_checkpoint(info["path"])
                start_epoch = int(info["epoch"]) + 1
                self.metrics.log(
                    {"kind": "resume", "epoch": start_epoch,
                     "step": info.get("step", -1)}
                )
        heartbeat = watchdog = None
        if self.cfg.heartbeat_interval > 0:
            from deepvcp.parallel.heartbeat import (
                Heartbeat,
                Watchdog,
                wait_for_all_hosts,
            )

            hb_dir = os.path.join(self.cfg.checkpoint_dir, "heartbeats")
            heartbeat = Heartbeat(
                hb_dir, jax.process_index(),
                interval=self.cfg.heartbeat_interval).start()
            wait_for_all_hosts(hb_dir, jax.process_count())
            watchdog = Watchdog(
                hb_dir, jax.process_count(), jax.process_index(),
                stale_after=self.cfg.heartbeat_stale_after,
                step_stale_after=4 * self.cfg.heartbeat_stale_after,
                grace_period=self.cfg.heartbeat_stale_after,
            )
        try:
            for epoch in range(start_epoch, self.cfg.num_epochs):
                avg = self.train_epoch(make_train_batches(epoch), epoch)
                self.metrics.log({"kind": "epoch", "epoch": epoch, **avg})
                if heartbeat is not None:
                    heartbeat.update(int(self.state.step))
                    watchdog.scan()
                if (epoch + 1) % self.cfg.checkpoint_every_epochs == 0:
                    self.save_checkpoint(f"epoch_{epoch}", epoch=epoch)
                if make_eval_batches is not None:
                    self.evaluate(make_eval_batches(epoch), epoch)
            self.save_checkpoint("final", epoch=self.cfg.num_epochs - 1)
        finally:
            if heartbeat is not None:
                heartbeat.stop()
