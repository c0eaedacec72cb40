"""Worker for tests/test_multihost.py: one jax.distributed CPU process.

Spawned twice (process_id 0 and 1); each process gets 2 local CPU devices,
the pair forms a 4-device global mesh, and both drive ONE sharded train
step of the tiny model through deepvcp's public make_train_step. The
loss is printed so the parent can assert the two processes agree (the
gradient all-reduce actually ran across processes).

Usage: python multihost_worker.py <coordinator_port> <process_id>
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# must precede any other jax use: the workers form a CPU mesh
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)


def main() -> None:
    port, pid = sys.argv[1], int(sys.argv[2])

    from deepvcp.parallel.multihost import (
        host_shard_info,
        initialize_multihost,
        is_primary_host,
    )

    ok = initialize_multihost(
        coordinator_address=f"localhost:{port}",
        num_processes=2,
        process_id=pid,
    )
    assert ok, "explicit multi-process init must succeed or raise"
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 4, jax.devices()
    host_id, num_hosts = host_shard_info()
    assert (host_id, num_hosts) == (pid, 2)
    assert is_primary_host() == (pid == 0)

    import numpy as np

    from deepvcp import DeepVCPConfig
    from deepvcp.config import TrainConfig
    from deepvcp.data import SyntheticDataset, batch_iterator
    from deepvcp.models import DeepVCP
    from deepvcp.parallel.mesh import make_mesh
    from deepvcp.train.trainer import create_train_state, make_train_step

    from deepvcp.parallel.mesh import shard_batch

    cfg = DeepVCPConfig.tiny(num_points=64, use_normal=False)
    tcfg = TrainConfig(batch_size=4)
    ds = SyntheticDataset(num_clouds=4, num_points=64, extent=2.0, seed=0)
    # the REAL multi-host data path: each process loads its disjoint local
    # shard and shard_batch assembles the global arrays
    local = next(
        batch_iterator(
            ds, 2, epoch=0, seed=0, host_id=host_id, num_hosts=num_hosts
        )
    )

    model = DeepVCP(cfg=cfg)
    state, tx = create_train_state(model, tcfg, local)
    # host-local numpy state: jit device_puts it per the replicated
    # sharding (committed single-device arrays cannot reshard across
    # processes)
    state = jax.tree_util.tree_map(np.asarray, state)

    mesh = make_mesh(data=4, point=1)  # spans both processes
    step = make_train_step(model, tx, tcfg, mesh=mesh)
    new_state, metrics = step(state, *shard_batch(mesh, local))
    loss = float(metrics["loss"])
    grad_norm = float(metrics["grad_norm"])
    assert np.isfinite(loss) and np.isfinite(grad_norm)
    print(f"MULTIHOST_OK pid={pid} processes={jax.process_count()} "
          f"loss={loss:.6f} grad_norm={grad_norm:.6f}", flush=True)


if __name__ == "__main__":
    main()
