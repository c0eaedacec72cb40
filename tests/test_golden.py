"""The module layer (models/nn.py) against golden outputs recorded from
the Flax implementation it replaced (tests/data/golden_model.npz, made
by scripts/record_golden.py on the CPU at Precision.HIGHEST): the same
variable tree, the same init, the same forward and the same training
step, and every registry checkpoint maps onto the tree key for key."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from deepvcp import DeepVCPConfig, pretrained
from deepvcp.config import TrainConfig
from deepvcp.models import DeepVCP
from deepvcp.train.trainer import TrainState, build_train_step
from deepvcp.utils.checkpoint import (
    flatten,
    load_nested,
    path_key,
    unflatten,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_model.npz")
_VARS = "tiny/variables/"


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as arc:
        return {k: arc[k] for k in arc.files}


def _tiny_variables(golden):
    return unflatten({k[len(_VARS):]: v for k, v in golden.items()
                      if k.startswith(_VARS)})


def _tiny_inputs(golden):
    return tuple(golden[f"tiny/{k}"] for k in ("src", "tgt", "R", "t"))


def test_init_matches_recorded_variables(golden):
    """A fresh init reproduces the recorded tree: the same keys (Flax's
    auto-names included), shapes and values."""
    model = DeepVCP(cfg=DeepVCPConfig.tiny(num_points=96))
    got = flatten(model.init(jax.random.key(0), *_tiny_inputs(golden)))
    want = {k[len(_VARS):]: v for k, v in golden.items()
            if k.startswith(_VARS)}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_tiny_forward_matches_golden(golden):
    model = DeepVCP(cfg=DeepVCPConfig.tiny(num_points=96))
    with jax.default_matmul_precision("highest"):
        kp, vcp, aux = model.apply(_tiny_variables(golden),
                                   *_tiny_inputs(golden))
    for name, got in (("kp", kp), ("vcp", vcp),
                      ("saliency", aux["saliency"]),
                      ("candidate_weights", aux["candidate_weights"])):
        np.testing.assert_allclose(np.asarray(got), golden[f"tiny/{name}"],
                                   atol=1e-5, err_msg=name)


def test_registry_checkpoint_forward_matches_golden(golden):
    cfg, variables = pretrained.load("kitti25", num_points=256)
    inputs = tuple(golden[f"kitti25/{k}"] for k in ("src", "tgt", "R", "t"))
    with jax.default_matmul_precision("highest"):
        kp, vcp, _ = DeepVCP(cfg=cfg).apply(variables, *inputs)
    np.testing.assert_allclose(np.asarray(kp), golden["kitti25/kp"],
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(vcp), golden["kitti25/vcp"],
                               atol=1e-5)


def test_train_step_loss_matches_golden(golden):
    """One training step (BatchNorm in training mode, its running
    statistics updated) gives the recorded loss and gradient norm."""
    model = DeepVCP(cfg=DeepVCPConfig.tiny(num_points=96))
    variables = _tiny_variables(golden)
    tcfg = TrainConfig()
    tx = optax.adam(tcfg.learning_rate)
    state = TrainState(params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]),
                       step=jnp.zeros((), jnp.int32))
    with jax.default_matmul_precision("highest"):
        new_state, metrics = jax.jit(build_train_step(model, tx, tcfg))(
            state, *_tiny_inputs(golden))
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(golden["train/loss"]), atol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(golden["train/grad_norm"]), rtol=1e-4)
    # training mode updated the running statistics
    before = flatten(variables["batch_stats"])
    after = flatten(new_state.batch_stats)
    assert sorted(before) == sorted(after)
    assert any(not np.array_equal(before[k], after[k]) for k in before)


@pytest.fixture(scope="module")
def registry_tree():
    """{key: shape} of the kitti-scale model's variables (the registry's
    architecture; shapes do not depend on num_points)."""
    cfg = DeepVCPConfig(num_points=128, use_normal=False, spatial_extent=55.0)
    xyz = jnp.asarray(np.random.default_rng(0).uniform(
        -20, 20, (1, 128, 3)).astype(np.float32))
    eye = jnp.eye(3, dtype=jnp.float32)[None]
    variables = jax.eval_shape(
        lambda: DeepVCP(cfg=cfg).init(jax.random.key(0), xyz, xyz, eye,
                                      jnp.zeros((1, 3))))
    return {path_key(path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                variables)[0]}


@pytest.mark.parametrize("name", sorted(pretrained.REGISTRY))
def test_registry_checkpoint_maps_onto_model(name, registry_tree):
    path = os.path.join(pretrained._ROOT, pretrained.REGISTRY[name]["path"])
    saved = {k: v.shape for k, v in flatten(load_nested(path)).items()}
    assert saved == registry_tree


class TestCheckpointArchive:
    def test_train_state_round_trip(self, tmp_path):
        """A whole training state (optax's nested state included) goes
        through save_tree / load_into unchanged."""
        from deepvcp.utils.checkpoint import load_into, save_tree

        params = {"a": {"kernel": np.arange(6, dtype=np.float32)
                        .reshape(2, 3)},
                  "b": np.ones(4, np.float32)}
        tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
        state = TrainState(params=params, batch_stats={"m": np.zeros(3)},
                           opt_state=tx.init(params),
                           step=np.int32(7))
        path = save_tree(str(tmp_path / "ck"), state)
        assert path.endswith(".npz")
        template = jax.tree_util.tree_map(np.zeros_like, state)
        back = load_into(str(tmp_path / "ck"), template)
        assert isinstance(back, TrainState)
        for (pa, a), (pb, b) in zip(
                jax.tree_util.tree_flatten_with_path(state)[0],
                jax.tree_util.tree_flatten_with_path(back)[0]):
            assert path_key(pa) == path_key(pb)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_load_into_rejects_other_architecture(self, tmp_path):
        from deepvcp.utils.checkpoint import load_into, save_tree

        save_tree(str(tmp_path / "ck"), {"w": np.zeros((2, 3))})
        with pytest.raises(ValueError, match="shape"):
            load_into(str(tmp_path / "ck"), {"w": np.zeros((3, 3))})
        with pytest.raises(KeyError, match="v"):
            load_into(str(tmp_path / "ck"), {"v": np.zeros((2, 3))})


@pytest.mark.parametrize("env", [None, "custom_cache"])
def test_compile_cache_dir(env, tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set the helper leaves JAX's setting
    alone; without it the cache is <repo>/.jax_cache."""
    from deepvcp.utils import cache

    before = jax.config.jax_compilation_cache_dir
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                           str(tmp_path / env))
    try:
        got = cache.enable_compile_cache()
        if env is None:
            root = os.path.dirname(os.path.dirname(os.path.abspath(
                __file__)))
            assert got == os.path.join(root, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
        else:
            assert got == str(tmp_path / env)
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
