"""Integration: training actually learns (loss decreases when overfitting
a tiny fixed problem). This is the end-to-end autodiff sanity the
reference never had."""

import numpy as np
import pytest

from deepvcp import DeepVCPConfig
from deepvcp.config import TrainConfig
from deepvcp.data import SyntheticDataset, batch_iterator
from deepvcp.train import Trainer


@pytest.mark.slow
def test_overfit_reduces_loss():
    model_cfg = DeepVCPConfig.tiny(num_points=64, use_normal=False)
    train_cfg = TrainConfig(
        num_epochs=1, batch_size=2, learning_rate=3e-3, metrics_path=None,
        log_every=1000,
    )
    ds = SyntheticDataset(num_clouds=2, num_points=64, extent=2.0)
    trainer = Trainer(model_cfg, train_cfg)
    # fixed batch: same pair every step (epoch=0 seeding)
    batch = next(batch_iterator(ds, 2, epoch=0, seed=0))
    trainer.setup(batch)

    import jax.numpy as jnp

    losses = []
    for _ in range(30):
        trainer.state, m = trainer._train_step(
            trainer.state, *(jnp.asarray(a) for a in batch)
        )
        losses.append(float(m["loss"]))

    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    assert np.isfinite(losses).all()
    assert last < first * 0.9, (first, last, losses[::5])


@pytest.mark.slow
def test_overfit_recovers_pose_gt_free():
    """With the paper's direct VCP term (vcp_loss_weight) the overfit
    problem must actually be SOLVED: on the training pair, the GT-free
    (identity-init) solve recovers the pose far better than at init —
    pose recovery, not just a relative loss drop (round-1/2 review: the
    10%-drop assertion was the only learning evidence in the repo)."""
    import jax
    import jax.numpy as jnp

    from deepvcp.loss.registration import svd_refine
    from deepvcp.utils import rotation_geodesic_deg, translation_error

    model_cfg = DeepVCPConfig.tiny(num_points=64, use_normal=False)
    # train-mode statistics converge by ~100 steps; the EVAL-mode (running
    # BN averages) numbers asserted below lag them by ~200 steps
    steps = 350
    train_cfg = TrainConfig(
        num_epochs=1, batch_size=2, learning_rate=3e-3, metrics_path=None,
        log_every=10000, vcp_loss_weight=1.0, lr_schedule="cosine",
        total_steps=steps, use_saliency_weights=True,
    )
    # small-motion pairs so the identity-init candidate grid covers the
    # true correspondence
    ds = SyntheticDataset(
        num_clouds=2, num_points=64, extent=2.0,
        max_rotation_deg=5.0, max_translation=0.4,
    )
    trainer = Trainer(model_cfg, train_cfg)
    batch = next(batch_iterator(ds, 2, epoch=0, seed=0))
    trainer.setup(batch)
    src, tgt, R_gt, t_gt = (jnp.asarray(a) for a in batch)

    def gt_free_errors(state):
        eye = jnp.broadcast_to(jnp.eye(3, dtype=src.dtype), (2, 3, 3))
        kp, vcp, _ = trainer.model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            src, tgt, eye, jnp.zeros((2, 3)), train=False,
        )
        ref = svd_refine(kp, vcp)
        return (
            float(jnp.mean(rotation_geodesic_deg(ref.R, R_gt))),
            float(jnp.mean(translation_error(ref.t, t_gt))),
        )

    rre0, rte0 = gt_free_errors(trainer.state)
    for _ in range(steps):
        trainer.state, m = trainer._train_step(
            trainer.state, src, tgt, R_gt, t_gt
        )
    assert np.isfinite(float(m["loss"]))
    rre1, rte1 = gt_free_errors(trainer.state)
    # the pose must actually be recovered on the overfit pair. (rre is
    # noise-limited: residual per-VCP error eps over a ~unit keypoint
    # lever arm gives rre ~ eps radians, so assert a sanity bound there
    # and the strong bound on rte.)
    assert rte1 < 0.25 * rte0, (rte0, rte1)
    assert rte1 < 0.1, (rte0, rte1)
    assert rre1 < 2.0, (rre0, rre1)
