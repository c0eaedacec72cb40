"""A small functional module layer: `Module`, `Dense`, `BatchNorm`, `Conv`.

The model is written as modules that create their parameters on first
use, the way Flax's compact modules do, and produces the same variable
tree: {"params": ..., "batch_stats": ...} nested by module name, with
unnamed submodules auto-named per class in call order ("Dense_0",
"Dense_1", ...), the counter restarting on each call of the parent. So
checkpoints written by the earlier Flax implementation map key for key.

    model = DeepVCP(cfg=cfg)
    variables = model.init(jax.random.key(0), src, tgt, R, t)
    out = model.apply(variables, src, tgt, R, t)
    out, updates = model.apply(variables, ..., train=True,
                               mutable=["batch_stats"])

A module is a dataclass whose `forward` runs inside a scope; calling a
module inside another's forward binds it to a child scope named by its
`name` field (or the auto-name). `BatchNorm` keeps Flax's defaults:
momentum 0.99, epsilon 1e-5, statistics in float32, and an optional
`axis_name` whose mean is taken with `lax.pmean` across devices.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

Dtype = Any
lecun_normal = jax.nn.initializers.lecun_normal()
zeros = jax.nn.initializers.zeros
ones = jax.nn.initializers.ones
relu = jax.nn.relu
softplus = jax.nn.softplus

_STACK = threading.local()


class _Frame:
    """The variables of one init/apply call and its flags."""

    def __init__(self, variables, rng, initializing, mutable):
        # rebuild the dict levels so writes never touch the caller's tree
        self.variables = jax.tree_util.tree_map(lambda x: x, dict(variables))
        self.rng = rng
        self.initializing = initializing
        self.mutable = set(mutable)
        self._rng_counts: Dict[Tuple[str, ...], int] = {}

    def param_rng(self, path: Tuple[str, ...]):
        """The key for the next parameter created under `path`: the root
        key folded with a hash of the path and a per-path counter, the
        derivation Flax uses, so a fresh init equals Flax's bit for bit."""
        count = self._rng_counts.get(path, 0) + 1
        self._rng_counts[path] = count
        digest = hashlib.sha1()
        for part in path:
            digest.update(part.encode("utf-8"))
        digest.update(count.to_bytes((count.bit_length() + 7) // 8, "big"))
        data = int.from_bytes(digest.digest()[:4], "big")
        return jax.random.fold_in(self.rng, jnp.uint32(data))


class _Scope:
    def __init__(self, frame: _Frame, path: Tuple[str, ...]):
        self.frame = frame
        self.path = path
        self._counters: Dict[str, int] = {}

    def child_name(self, kind: str) -> str:
        i = self._counters.get(kind, 0)
        self._counters[kind] = i + 1
        return f"{kind}_{i}"

    def _node(self, collection: str, create: bool):
        node = self.frame.variables
        for key in (collection,) + self.path:
            if key not in node:
                if not create:
                    return None
                node[key] = {}
            node = node[key]
        return node

    def get(self, collection: str, name: str, init: Callable[[], Any]):
        node = self._node(collection, self.frame.initializing)
        if node is not None and name in node:
            return node[name]
        if not self.frame.initializing:
            raise KeyError(
                f"variable {collection}/{'/'.join(self.path + (name,))} "
                f"is missing: the variables do not match this model")
        node[name] = init()
        return node[name]

    def put(self, collection: str, name: str, value) -> None:
        if not (self.frame.initializing or collection in self.frame.mutable):
            raise ValueError(
                f"collection {collection!r} is not mutable: pass "
                f"mutable=[{collection!r}] to apply")
        self._node(collection, True)[name] = value


def _current() -> _Scope:
    stack = getattr(_STACK, "scopes", None)
    if not stack:
        raise RuntimeError("modules run only inside init() or apply()")
    return stack[-1]


def _run(scope: _Scope, fn, *args, **kwargs):
    stack = _STACK.__dict__.setdefault("scopes", [])
    stack.append(scope)
    try:
        return fn(*args, **kwargs)
    finally:
        stack.pop()


@dataclasses.dataclass(eq=False)
class Module:
    """Base class: subclasses are dataclasses that implement `forward`."""

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        parent = _current()
        name = self.name or parent.child_name(type(self).__name__)
        scope = _Scope(parent.frame, parent.path + (name,))
        return _run(scope, self.forward, *args, **kwargs)

    def param(self, name: str, init_fn, shape, dtype=jnp.float32):
        scope = _current()
        value = scope.get(
            "params", name,
            lambda: init_fn(scope.frame.param_rng(scope.path), shape, dtype))
        if tuple(jnp.shape(value)) != tuple(shape):
            raise ValueError(
                f"parameter {'/'.join(scope.path + (name,))} has shape "
                f"{jnp.shape(value)}, the model expects {tuple(shape)}")
        return value

    def init(self, rng, *args, **kwargs) -> Dict[str, Any]:
        """The model's variables, created by one forward on these inputs."""
        frame = _Frame({}, rng, initializing=True, mutable=())
        _run(_Scope(frame, ()), self.forward, *args, **kwargs)
        return frame.variables

    def apply(self, variables, *args, mutable: Sequence[str] = (),
              **kwargs):
        """Run forward with `variables`. With `mutable` collections,
        returns (output, {collection: updated tree})."""
        frame = _Frame(variables, None, initializing=False, mutable=mutable)
        out = _run(_Scope(frame, ()), self.forward, *args, **kwargs)
        if not mutable:
            return out
        return out, {c: frame.variables.get(c, {}) for c in mutable}


def is_initializing() -> bool:
    return _current().frame.initializing


@dataclasses.dataclass(eq=False)
class Dense(Module):
    """y = x @ kernel + bias, kernel [in, out] (lecun-normal init)."""

    features: int
    use_bias: bool = True
    dtype: Dtype = jnp.float32

    def forward(self, x):
        kernel = self.param("kernel", lecun_normal,
                            (x.shape[-1], self.features))
        x = jnp.asarray(x, self.dtype)
        y = jax.lax.dot_general(
            x, jnp.asarray(kernel, self.dtype),
            (((x.ndim - 1,), (0,)), ((), ())))
        if self.use_bias:
            bias = self.param("bias", zeros, (self.features,))
            y = y + jnp.reshape(jnp.asarray(bias, self.dtype),
                                (1,) * (y.ndim - 1) + (-1,))
        return y


@dataclasses.dataclass(eq=False)
class Conv(Module):
    """3-D convolution over channels-last [N, D, H, W, C], SAME padding,
    kernel [kd, kh, kw, in, out]."""

    features: int
    kernel_size: Tuple[int, int, int] = (3, 3, 3)
    dtype: Dtype = jnp.float32

    def forward(self, x):
        kernel = self.param(
            "kernel", lecun_normal,
            tuple(self.kernel_size) + (x.shape[-1], self.features))
        bias = self.param("bias", zeros, (self.features,))
        y = jax.lax.conv_general_dilated(
            jnp.asarray(x, self.dtype), jnp.asarray(kernel, self.dtype),
            window_strides=(1, 1, 1), padding="SAME",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
        return y + jnp.reshape(jnp.asarray(bias, self.dtype),
                               (1,) * (y.ndim - 1) + (-1,))


@dataclasses.dataclass(eq=False)
class BatchNorm(Module):
    """Batch normalization over every axis but the last.

    In training (`use_running_average=False`) it normalizes with the
    batch statistics, averaged over `axis_name` when set, and updates the
    running statistics in "batch_stats" (not while initializing)."""

    use_running_average: bool = False
    axis_name: Optional[str] = None
    momentum: float = 0.99
    epsilon: float = 1e-5
    dtype: Dtype = jnp.float32

    def forward(self, x):
        scope = _current()
        feat = (x.shape[-1],)
        axes = tuple(range(x.ndim - 1))
        ra_mean = scope.get("batch_stats", "mean",
                            lambda: jnp.zeros(feat, jnp.float32))
        ra_var = scope.get("batch_stats", "var",
                           lambda: jnp.ones(feat, jnp.float32))
        if self.use_running_average:
            mean, var = ra_mean, ra_var
        else:
            xf = jnp.asarray(x, jnp.promote_types(self.dtype, jnp.float32))
            mu, mu2 = xf.mean(axes), jnp.square(xf).mean(axes)
            if self.axis_name is not None and not is_initializing():
                both = jax.lax.pmean(jnp.stack([mu, mu2]), self.axis_name)
                mu, mu2 = both[0], both[1]
            mean, var = mu, jnp.maximum(0.0, mu2 - jnp.square(mu))
            if not is_initializing():
                scope.put("batch_stats", "mean",
                          self.momentum * ra_mean + (1 - self.momentum) * mean)
                scope.put("batch_stats", "var",
                          self.momentum * ra_var + (1 - self.momentum) * var)
        scale = self.param("scale", ones, feat)
        bias = self.param("bias", zeros, feat)
        y = x - mean
        mul = jax.lax.rsqrt(var + self.epsilon) * scale
        y = y * mul
        y = y + bias
        return jnp.asarray(y, self.dtype)
