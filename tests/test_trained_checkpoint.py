"""Trained-checkpoint regression test (VERDICT round-3 ask #2's "done"
criterion: refinement verified non-worsening on a *trained* model, not a
mock or an untrained net).

Loads the committed round-4 fine-grid checkpoint
(artifacts/campaign_r4/model_fine/final — trained at N=10 000 with the
residual-init recipe) and runs it at N=1024: every parameter is a
per-point MLP / conv weight, so the same tree applies at any cloud size.
The reference has no analogue — it ships no weights and no accuracy
tests (/root/reference/train.py:113-120 prints errors, asserts nothing).

Runtime note: one Registrar(refine_iters=2) compile on CPU is the cost
(~1 min); everything is batched into a single call.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax.numpy as jnp

from deepvcp import DeepVCPConfig
from deepvcp.data import SyntheticDataset, batch_iterator
from deepvcp.pretrained import load_variables
from deepvcp.registration import Registrar
from deepvcp.utils.rotations import rotation_geodesic_deg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "artifacts", "campaign_r4", "model_fine", "final")


@pytest.mark.skipif(not os.path.exists(CKPT + ".npz"),
                    reason="round-4 campaign checkpoint not present")
def test_trained_model_gt_free_accuracy_and_guard():
    N = 1024
    # the fine-grid arch the checkpoint was trained with (see
    # final.arch.json beside it); num_points is not an arch parameter
    cfg = DeepVCPConfig(num_points=N, use_normal=False, spatial_extent=2.5,
                        search_radius=0.6, voxel_len=0.2)
    ds = SyntheticDataset(num_clouds=2, num_points=N, extent=1.0, seed=100,
                          max_rotation_deg=10.0, max_translation=0.5)
    sample = next(batch_iterator(ds, 2, epoch=0, seed=0))
    variables = load_variables(CKPT)

    reg = Registrar(cfg, variables, use_saliency_weights=True,
                    refine_iters=2)
    src, tgt, R, t = (jnp.asarray(a) for a in sample)
    out = reg(src, tgt)                       # identity init — GT-free

    rre = np.asarray(rotation_geodesic_deg(out.R, R))
    rte = np.asarray(jnp.linalg.norm(out.t - t, axis=-1))
    # thresholds: measured 1.8 deg / 0.05 at this seed; identity init on
    # this held-out set is up to 10 deg / 0.87 — a wide real margin
    assert rre.max() <= 5.0, rre
    assert rte.max() <= 0.15, rte

    # the guard's accepted score can only improve with iterations: the
    # best-so-far over cols 0..i is non-increasing in i
    sc = np.asarray(out.scores)               # [B, iters+1], col 0 = init
    best = np.minimum.accumulate(sc, axis=1)
    assert (np.diff(best, axis=1) <= 1e-7).all(), sc
    # and a trained model must actually beat the identity-init score
    assert (best[:, -1] < sc[:, 0] - 1e-4).all(), sc
