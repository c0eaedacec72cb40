"""Saliency-weighted solve (trains the weighting layer) and the bfloat16
compute path."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from deepvcp import DeepVCPConfig
from deepvcp.config import TrainConfig
from deepvcp.data import SyntheticDataset, batch_iterator
from deepvcp.models import DeepVCP
from deepvcp.train.trainer import create_train_state, make_train_step


def _setup(train_cfg, model_cfg=None):
    model_cfg = model_cfg or DeepVCPConfig.tiny(num_points=64, use_normal=False)
    model = DeepVCP(cfg=model_cfg)
    ds = SyntheticDataset(num_clouds=4, num_points=model_cfg.num_points, extent=2.0)
    batch = next(batch_iterator(ds, 2, epoch=0, seed=0))
    state, tx = create_train_state(model, train_cfg, batch)
    step = make_train_step(model, tx, train_cfg)
    return model, state, step, batch


def _wl_grad_norm(state_before, state_after):
    import jax

    diffs = jax.tree_util.tree_map(
        lambda a, b: float(jnp.sum(jnp.abs(a - b))),
        state_before.params["wl"],
        state_after.params["wl"],
    )
    return sum(jax.tree_util.tree_leaves(diffs))


class TestSaliencyWeights:
    def test_weighting_layer_trains_only_with_flag(self):
        import jax

        copy = lambda s: jax.tree_util.tree_map(jnp.copy, s)

        # without the flag: WL params receive no gradient (reference
        # behavior — top-k indices only)
        cfg_off = TrainConfig(batch_size=2, metrics_path=None)
        _, state, step, batch = _setup(cfg_off)
        s0 = copy(state)
        s1, _ = step(copy(state), *(jnp.asarray(a) for a in batch))
        assert _wl_grad_norm(s0, s1) == 0.0

        # with the flag: saliency enters the Kabsch weights -> WL trains
        cfg_on = TrainConfig(
            batch_size=2, metrics_path=None, use_saliency_weights=True
        )
        _, state, step, batch = _setup(cfg_on)
        s0 = copy(state)
        s1, m = step(copy(state), *(jnp.asarray(a) for a in batch))
        assert np.isfinite(float(m["loss"]))
        assert _wl_grad_norm(s0, s1) > 0.0


class TestBF16:
    def test_forward_in_bfloat16(self):
        cfg = dataclasses.replace(
            DeepVCPConfig.tiny(num_points=64, use_normal=False),
            compute_dtype="bfloat16",
        )
        model = DeepVCP(cfg=cfg)
        rng = np.random.default_rng(0)
        src = jnp.asarray(rng.uniform(-1, 1, (1, 64, 3)).astype(np.float32))
        R = jnp.eye(3)[None]
        t = jnp.zeros((1, 3))
        vs = model.init(jax.random.key(0), src, src, R, t)
        kp, vcp, _ = model.apply(vs, src, src, R, t)
        assert np.isfinite(np.asarray(vcp, np.float32)).all()
        # geometry outputs stay in a float type usable by the f32 solver
        from deepvcp.loss import deepvcp_loss

        res = deepvcp_loss(
            kp.astype(jnp.float32), vcp.astype(jnp.float32), R, t
        )
        assert np.isfinite(float(res.loss))
