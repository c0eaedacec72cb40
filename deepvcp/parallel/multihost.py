"""Multi-host setup (SURVEY.md parallelism table: the reference's
DataParallel has no multi-host analogue; ours is jax.distributed +
per-host disjoint data shards + the same pjit train step).

On a multi-host cluster, call `initialize_multihost()` once at program
start; the mesh from parallel.make_mesh then spans all hosts' devices and
the jitted train step is unchanged (GSPMD handles the cross-host
collectives). Data loading uses `host_shard_info()` with
`data.batch_iterator(..., host_id=..., num_hosts=...)` so each host reads
a disjoint stride of the index stream.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import jax


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed when running multi-process.

    Semantics (round-2 review: a bare `except Exception: return False`
    silently degraded a misconfigured multi-host run to one host):

    - EXPLICIT arguments (a coordinator address or process topology was
      given): the caller declared a multi-process run, so any
      initialization failure is a configuration error and RAISES.
    - no arguments (auto-discovery): single-process environments are
      expected and return False, but with a loud warning naming the cause
      so a multi-host run that lands here is visible in the logs.

    Launchers that export the cluster layout need no explicit arguments;
    elsewhere pass all three. Tested for real by tests/test_multihost.py:
    two spawned jax.distributed CPU processes drive one sharded train
    step.
    """
    # NB: must not touch the XLA backend before jax.distributed.initialize
    # (jax.process_count() would initialize it), so the idempotence check
    # uses jax.distributed's own state
    if jax.distributed.is_initialized():
        return jax.process_count() > 1
    explicit = any(
        a is not None for a in (coordinator_address, num_processes, process_id)
    )
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except Exception as e:
        if explicit:
            raise RuntimeError(
                "jax.distributed.initialize failed for an explicitly "
                f"configured multi-process run: {e!r}"
            ) from e
        warnings.warn(
            f"multi-host auto-initialization unavailable ({e!r}); "
            "continuing single-process",
            stacklevel=2,
        )
        return False
    return jax.process_count() > 1


def host_shard_info() -> Tuple[int, int]:
    """(host_id, num_hosts) for per-host data sharding."""
    return jax.process_index(), jax.process_count()


def is_primary_host() -> bool:
    """Checkpoint/metrics writers should run on one host only."""
    return jax.process_index() == 0
