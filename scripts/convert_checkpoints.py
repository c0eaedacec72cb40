"""Convert the registry's orbax checkpoints to the numpy format.

Each registry entry (deepvcp.pretrained.REGISTRY) names an orbax
checkpoint directory written by the training campaigns. This script
restores its params and batch_stats with orbax and writes them to
`<path>.npz` beside `<path>.arch.json`, which is what
`pretrained.load` reads. Only this script needs orbax. The orbax
directories were removed from the tree once converted; run it in a
checkout of the history that still holds them:

    JAX_PLATFORMS=cpu python scripts/convert_checkpoints.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def restore_orbax(path: str) -> dict:
    import jax
    import jax.sharding as jsh
    import orbax.checkpoint as ocp

    sh = jsh.SingleDeviceSharding(jax.devices()[0])

    def absify(m):
        if hasattr(m, "shape"):
            return jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=sh)
        return m

    with ocp.StandardCheckpointer() as ckptr:
        meta = ckptr.metadata(path).item_metadata
        restored = ckptr.restore(path, jax.tree_util.tree_map(absify,
                                                              dict(meta)))
    return {"params": restored["params"],
            "batch_stats": restored["batch_stats"]}


def main() -> None:
    from deepvcp.pretrained import REGISTRY
    from deepvcp.utils.checkpoint import save_tree

    for name, entry in sorted(REGISTRY.items()):
        path = os.path.join(ROOT, entry["path"])
        out = save_tree(path, restore_orbax(path))
        print(f"{name}: {os.path.relpath(out, ROOT)} "
              f"({os.path.getsize(out)} bytes)")


if __name__ == "__main__":
    main()
