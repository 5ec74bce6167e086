"""Multi-host launch helper.

On several hosts, run the same program on every host and call
:func:`initialize` first — it wires up ``jax.distributed`` — then build the
global mesh spanning every device. The sweep itself is host-count-agnostic:
the GSPMD and halo paths only see the mesh.

Single-process multi-device (one host, N cards) needs no initialization;
``make_mesh`` over ``jax.devices()`` suffices.
"""

from __future__ import annotations

import jax
import numpy as np

from .mesh import make_mesh

__all__ = ["initialize", "global_mesh", "host_to_global"]


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Initialize the JAX distributed runtime (no-op if single process).

    Pass the coordinator address (``host:port``), the process count and
    this process's id explicitly: nothing detects a cluster by itself.
    """
    if num_processes is not None and num_processes > 1 or coordinator_address:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_count()


def global_mesh(dp: int = 1):
    """The (dp, x, y) mesh over every device in the job."""
    return make_mesh(len(jax.devices()), dp=dp)


def host_to_global(tree, shardings):
    """Build globally-sharded device arrays from identical per-host data.

    In a multi-process job a plain ``jax.device_put`` cannot target
    non-addressable devices; each process instead contributes its local
    shards via ``jax.make_array_from_callback``. ``tree`` holds the full
    (host) value of every leaf — the same on every process, which is how the
    solver's problem/state are constructed (deterministic seeded init) —
    and ``shardings`` the matching NamedSharding pytree (see
    :func:`gqmap_tpu.parallel.sharded.problem_sharding` /
    :func:`gqmap_tpu.parallel.mesh.state_sharding`).
    """

    def put(x, sh):
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])

    return jax.tree_util.tree_map(put, tree, shardings)
