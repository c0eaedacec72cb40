"""Diagnose model A3's rotation failure on CPU from its checkpoint.

Decomposes the per-keypoint VCP error e_k = vcp_k - (R_gt kp_k + t_gt)
under a GT warm start into a global bias (hurts only translation) and a
residual scatter (what the SVD solve turns into rotation error), and
measures the keypoint constellation's spread (the lever arm): rotation
noise ~ scatter / lever.
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_platforms", "cpu")
import dataclasses
import numpy as np
import jax.numpy as jnp
import orbax.checkpoint as ocp

from deepvcp import DeepVCPConfig
from deepvcp.data import SyntheticDataset, LidarLikeDataset, batch_iterator
from deepvcp.models import DeepVCP

N = int(os.environ.get("DIAG_N", "10000"))
cfg = DeepVCPConfig(num_points=N, use_normal=False, spatial_extent=2.5, neighbor_method=os.environ.get("DIAG_ENGINE", "banded"))
model = DeepVCP(cfg=cfg)

ck = os.path.join("artifacts", "campaign_r3c", "model_a3", "final")
held_u = SyntheticDataset(num_clouds=2, num_points=N, extent=1.0, seed=100,
                          max_rotation_deg=10.0, max_translation=0.5)
held_l = LidarLikeDataset(num_clouds=2, num_points=N, max_range=1.0,
                          seed=101, max_rotation_deg=10.0,
                          max_translation=0.5)

from deepvcp.config import TrainConfig
from deepvcp.train import Trainer

sample = next(batch_iterator(held_u, 1, epoch=0, seed=7))
# TrainConfig must match the campaign's (the opt_state tree includes the
# schedule state, and orbax restores into an exact-shape target)
tr = Trainer(cfg, TrainConfig(
    batch_size=1, learning_rate=1e-3, vcp_loss_weight=1.0,
    lr_schedule="cosine", warmup_steps=100, use_saliency_weights=True,
    total_steps=33 * 384,
    metrics_path="/tmp/diag_m.jsonl", checkpoint_dir="/tmp/diag_ck"))
tr.setup(sample)
tr.load_checkpoint(ck)
variables = {"params": tr.state.params, "batch_stats": tr.state.batch_stats}

for name, ds in (("uniform", held_u), ("lidar", held_l)):
    src, tgt, R, t = next(batch_iterator(ds, 1, epoch=0, seed=7))
    src, tgt, R, t = (jnp.asarray(a) for a in (src, tgt, R, t))
    kp, vcp, aux = model.apply(variables, src, tgt, R,
                               jnp.zeros_like(t), train=False)
    kp_true = jnp.einsum("bkj,bij->bki", kp, R) + t[:, None, :]
    e = np.asarray(vcp - kp_true)[0]          # [K,3]
    kpn = np.asarray(kp)[0]
    sal = np.asarray(aux["keypoint_saliency"])[0]
    bias = e.mean(0)
    scatter = e - bias
    lever = np.sqrt(((kpn - kpn.mean(0)) ** 2).sum(-1).mean())
    cloud = np.asarray(src)[0, :, :3]
    cloud_lever = np.sqrt(((cloud - cloud.mean(0)) ** 2).sum(-1).mean())
    print(f"[{name}] |bias|={np.linalg.norm(bias):.4f} "
          f"scatter_rms={np.sqrt((scatter**2).sum(-1).mean()):.4f} "
          f"median|e|={np.median(np.linalg.norm(e,axis=-1)):.4f} "
          f"kp_lever={lever:.3f} cloud_lever={cloud_lever:.3f} "
          f"pred_rot_noise_deg={np.degrees(np.sqrt((scatter**2).sum(-1).mean())/max(lever,1e-6)):.1f} "
          f"sal=[{sal.min():.3f},{sal.max():.3f}]")
