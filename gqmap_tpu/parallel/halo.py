"""Hand-scheduled distributed sweep: shard_map + explicit ppermute halos.

The GSPMD path (:mod:`gqmap_tpu.parallel.sharded`) lets XLA partition the
single-device program. This module is the explicit alternative: the lattice
is block-sharded over the ``(x, y)`` mesh axes, each sweep exchanges
exactly one boundary row/column of the per-site Gaussian parameters with
its grid neighbors via ``lax.ppermute`` (neighbor-ring traffic),
and the Energy/dalpha/|dmu| scalars are psum'd — the communication pattern
SURVEY.md §2.5 prescribes for the spatial-decomposition axis, written out
by hand. Each shard runs the GPU kernels on its local block
(:func:`gqmap_tpu.models.gqmap.use_kernel`).

Semantics are identical to the single-device sweep (the wrap-around halo
reproduces ``circshift``; the frozen border ring makes the wrap contribution
inert, exactly as in the reference — ``gqmap_gpu_mixture.m:37-46``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map as _shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..config import GQMAPConfig
from ..models.gqmap import DistHooks, GQState, Problem, make_sweep

__all__ = ["halo_roll", "make_halo_sweep"]


def _ring_perm(n: int, direction: int):
    """Send perm for a ring: device i -> i+direction (mod n)."""
    return [(i, (i + direction) % n) for i in range(n)]


def halo_roll(x, shift: int, axis: int, axis_name: str, n_shards: int):
    """Global ``jnp.roll(x, shift, axis)`` over an ``axis_name``-sharded dim.

    Only +-1 shifts (the stencil halo) are supported: the boundary slice is
    exchanged with the ring neighbor, everything else is a local shift.
    """
    if n_shards == 1:
        return jnp.roll(x, shift, axis)
    if shift == -1:
        # out[i] = x[i+1]: send my FIRST slice to the previous device.
        first = jax.lax.slice_in_dim(x, 0, 1, axis=axis)
        recv = jax.lax.ppermute(first, axis_name, _ring_perm(n_shards, -1))
        rest = jax.lax.slice_in_dim(x, 1, None, axis=axis)
        return jnp.concatenate([rest, recv], axis=axis)
    if shift == 1:
        # out[i] = x[i-1]: send my LAST slice to the next device.
        last = jax.lax.slice_in_dim(x, x.shape[axis] - 1, None, axis=axis)
        recv = jax.lax.ppermute(last, axis_name, _ring_perm(n_shards, +1))
        rest = jax.lax.slice_in_dim(x, 0, x.shape[axis] - 1, axis=axis)
        return jnp.concatenate([recv, rest], axis=axis)
    raise ValueError(f"halo_roll supports shift +-1, got {shift}")


def make_halo_sweep(cfg: GQMAPConfig, image_shape, mesh: Mesh):
    """Build the jit(shard_map(...)) sweep over mesh axes ('x', 'y').

    Lattice dims must divide the mesh; the frame constants stay replicated
    while frame 1 is sliced per-shard inside the kernel (origin-aware node
    potential).
    """
    from ..models.gqmap import flow_lattice_shape

    M, N = flow_lattice_shape(cfg, image_shape)
    px = mesh.shape["x"]
    py = mesh.shape["y"]
    if M % px or N % py:
        raise ValueError(f"lattice {(M, N)} not divisible by mesh {(px, py)}")
    ml, nl = M // px, N // py

    def roll(x, shift, axis):
        ax = x.ndim + axis if axis < 0 else axis
        if ax == x.ndim - 2:
            return halo_roll(x, shift, -2, "x", px)
        if ax == x.ndim - 1:
            return halo_roll(x, shift, -1, "y", py)
        raise ValueError(axis)

    def psum(v):
        return jax.lax.psum(v, ("x", "y"))

    def origin():
        return (
            jax.lax.axis_index("x") * ml,
            jax.lax.axis_index("y") * nl,
        )

    hooks = DistHooks(roll=roll, psum=psum, origin=origin, local_lattice=(ml, nl))
    body = make_sweep(cfg, image_shape, dist=hooks)

    lat = P(None, "x", "y")
    state_specs = GQState(
        w=P(), muu=lat, muv=lat, sigmau=lat, sigmav=lat, pn=lat,
        rou=P(None, None, None, "x", "y"), temperature=P(), it=P(),
    )
    from ..config import FlowRange
    from .sharded import _cheb_cls

    # Per-site constants shard with the lattice: the spectral coefficient
    # field (A, B, M, N) and the quadratic-prior init flow (M, N, 2) arrive
    # inside the shard body as local blocks, so the spectral node terms need
    # no halo at all (they are gather-free and local per pixel).
    cheb_specs = None
    cls = _cheb_cls(cfg.data_term)
    if cls is not None:
        cheb_specs = cls(P(None, None, "x", "y"), P(), P(), P(), P())
    init_flow_specs = P("x", "y", None) if cfg.data_term == "quadratic" else None
    grad_specs = (P(), P()) if cfg.gradient_estimator == "prewitt" else None
    problem_specs = Problem(
        I1=P(), I2_tab=P(), interior=P("x", "y"),
        rng=FlowRange(P(), P(), P(), P()),
        cheb=cheb_specs, init_flow=init_flow_specs, grad_tabs=grad_specs,
    )
    from ..models.gqmap import SweepAux

    out_specs = (state_specs, SweepAux(P(), P(), P()))

    mapped = _shard_map(
        body,
        mesh=mesh,
        in_specs=(problem_specs, state_specs),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(mapped)
