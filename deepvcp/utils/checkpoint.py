"""Checkpoints as flat ``.npz`` archives keyed by tree path.

A pytree of arrays is stored as one numpy archive whose keys are the
leaves' tree paths joined by "/" ("params/fe/sa1/proj_xyz/kernel",
"opt_state/1/0/mu/cpg/Conv_0/bias", "step"). Reading needs nothing but
numpy: `load_nested` rebuilds nested dicts (model variables), and
`load_into` fills the leaves of a template tree of the same structure
(a whole training state, optimizer included).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import jax
import numpy as np


def path_key(path) -> str:
    """"a/b/c" for a jax tree path."""
    parts = []
    for entry in path:
        for attr in ("key", "name", "idx"):
            if hasattr(entry, attr):
                parts.append(str(getattr(entry, attr)))
                break
        else:
            raise TypeError(f"unsupported tree path entry {entry!r}")
    return "/".join(parts)


def flatten(tree: Any) -> Dict[str, np.ndarray]:
    """{"a/b/c": leaf} for every array leaf of `tree`."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = path_key(path)
        if key in flat:
            raise ValueError(f"duplicate checkpoint key {key!r}")
        flat[key] = np.asarray(leaf)
    return flat


def save_tree(path: str, tree: Any) -> str:
    """Write `tree` to `path` (".npz" appended when missing); the write
    goes to a temporary file first and is renamed into place, so a crash
    never leaves a truncated checkpoint under the final name."""
    if not path.endswith(".npz"):
        path += ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flatten(tree))
    os.replace(tmp, path)
    return path


def _open(path: str):
    if not path.endswith(".npz"):
        path += ".npz"
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return np.load(path)


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dicts from {"a/b/c": leaf}."""
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        *parents, leaf = key.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def load_nested(path: str) -> Dict[str, Any]:
    """The archive as nested dicts of numpy arrays."""
    with _open(path) as arc:
        return unflatten({key: arc[key] for key in arc.files})


def load_into(path: str, template: Any) -> Any:
    """A tree shaped like `template` with every leaf read from the
    archive. Missing keys and shape mismatches raise: a checkpoint from a
    different architecture must not restore silently."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    out = []
    with _open(path) as arc:
        for p, leaf in leaves:
            key = path_key(p)
            if key not in arc.files:
                raise KeyError(f"checkpoint {path} has no entry {key!r}")
            arr = arc[key]
            if arr.shape != np.shape(leaf):
                raise ValueError(
                    f"checkpoint {path} entry {key!r} has shape "
                    f"{arr.shape}, expected {np.shape(leaf)}")
            out.append(arr.astype(np.asarray(leaf).dtype))
    return jax.tree_util.tree_unflatten(treedef, out)
