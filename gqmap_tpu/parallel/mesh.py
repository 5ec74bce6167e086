"""Device-mesh construction and sharding specs for the GQMAP lattice.

Parallelism axes (SURVEY.md section 2.5):

* ``dp`` — data parallelism over frames/sequences (the reference's
  sequential driver loop, ``optical_flow.m:5``, turned into a batch axis);
* ``x`` / ``y`` — 2-D spatial block-sharding of the pixel lattice (the
  large-image scaling axis; absent in the single-GPU reference). Every
  neighbor gather/scatter is a ``jnp.roll``, which XLA's SPMD partitioner
  lowers to collective-permutes; the Energy/dalpha/|dmu| reductions become
  psums. The cards of a host are joined all to all (NVLink), so the mesh
  shape follows the lattice alone.

Image constants (frame 1 and the padded frame 2) are replicated: at
Middlebury scale they are ~1 MB and every node's bounded-range bicubic
gather can touch an arbitrary window of frame 2.
"""

from __future__ import annotations

import math

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.gqmap import GQState

__all__ = ["make_mesh", "state_sharding", "factor_2d"]


def factor_2d(n: int) -> tuple[int, int]:
    """Near-square factorization n = a*b with a <= b."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def make_mesh(n_devices: int | None = None, dp: int = 1, devices=None) -> Mesh:
    """Build a ``(dp, x, y)`` mesh over the first ``n_devices`` devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices % dp:
        raise ValueError(f"dp={dp} does not divide n_devices={n_devices}")
    x, y = factor_2d(n_devices // dp)
    import numpy as np

    arr = np.asarray(devices[:n_devices]).reshape(dp, x, y)
    return Mesh(arr, ("dp", "x", "y"))


def make_mesh_for_shape(M: int, N: int, n_devices: int | None = None, dp: int = 1, devices=None) -> Mesh:
    """Largest ``(dp, x, y)`` mesh with ``x | M`` and ``y | N``.

    GSPMD requires the sharded lattice dims to divide evenly; this picks the
    maximal divisor pair fitting the device budget (spare devices are left
    unused rather than failing).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    budget = n_devices // dp
    best = (1, 1)
    for x in range(1, min(M, budget) + 1):
        if M % x:
            continue
        y = budget // x
        while y > 1 and N % y:
            y -= 1
        if x * y > best[0] * best[1]:
            best = (x, y)
    x, y = best
    import numpy as np

    arr = np.asarray(devices[: dp * x * y]).reshape(dp, x, y)
    return Mesh(arr, ("dp", "x", "y"))


def state_sharding(mesh: Mesh, batched: bool = False) -> GQState:
    """NamedShardings for every GQState leaf (optionally with a leading
    dp-sharded batch axis)."""
    lead = ("dp",) if batched else ()

    def s(*dims):
        return NamedSharding(mesh, P(*lead, *dims))

    return GQState(
        w=s(None),
        muu=s(None, "x", "y"),
        muv=s(None, "x", "y"),
        sigmau=s(None, "x", "y"),
        sigmav=s(None, "x", "y"),
        pn=s(None, "x", "y"),
        rou=s(None, None, None, "x", "y"),
        temperature=s(),
        it=s(),
    )


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
