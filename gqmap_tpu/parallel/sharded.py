"""Mesh-sharded GQMAP sweeps (pjit / GSPMD path).

The single-device sweep (:mod:`gqmap_tpu.models.gqmap`) is already one pure
XLA program over the whole lattice, so distribution is sharding-annotation
only: jit the same function with NamedShardings and let the SPMD partitioner
insert the halo collective-permutes (for ``jnp.roll``) and psums (for the
Energy/dalpha/|dmu| scalars). This stands in for the reference's
planned-but-never-written distributed backend
(``legacy/gqmap_cuda.m``). The frame constants are replicated (~1 MB at
Middlebury scale; every node's bounded-range bicubic gather may touch an
arbitrary window of frame 2).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import GQMAPConfig
from ..models.gqmap import GQState, Problem, make_sweep
from .mesh import state_sharding

__all__ = [
    "problem_sharding",
    "make_sharded_sweep",
    "make_batched_sharded_sweep",
    "shard_state",
    "shard_problem",
    "stack_states",
]


def _cheb_cls(data_term: str):
    if data_term == "chebyshev":
        from ..ops.chebyshev import ChebData

        return ChebData
    if data_term == "cosine":
        from ..ops.cosine import CosData

        return CosData
    return None


def problem_sharding(mesh: Mesh, cfg: GQMAPConfig | None = None) -> Problem:
    """Shardings mirroring the problem pytree for ``cfg.data_term``.

    The frames stay replicated (bounded-range bicubic gathers may touch an
    arbitrary window of frame 2), but the spectral coefficient field — the
    dominant per-run constant, (A, B, M, N) ~ GBs at flagship scale — is
    strictly per-site and block-shards with the lattice, as do the interior
    mask and the quadratic-term init flow.
    """
    rep = NamedSharding(mesh, P())
    lat = NamedSharding(mesh, P("x", "y"))
    from ..config import FlowRange

    cheb = None
    init_flow = None
    grad_tabs = None
    if cfg is not None:
        cls = _cheb_cls(cfg.data_term)
        if cls is not None:
            cheb = cls(NamedSharding(mesh, P(None, None, "x", "y")), rep, rep, rep, rep)
        elif cfg.data_term == "quadratic":
            init_flow = NamedSharding(mesh, P("x", "y", None))
        if cfg.gradient_estimator == "prewitt":
            grad_tabs = (rep, rep)
    return Problem(I1=rep, I2_tab=rep, interior=lat,
                   rng=FlowRange(rep, rep, rep, rep), cheb=cheb,
                   init_flow=init_flow, grad_tabs=grad_tabs)


def shard_problem(problem: Problem, mesh: Mesh) -> Problem:
    """Place every per-run constant with its :func:`problem_sharding` layout
    (coefficient field lattice-sharded, frames replicated)."""
    rep = NamedSharding(mesh, P())
    cheb = problem.cheb
    if cheb is not None:
        cheb = type(cheb)(
            coeffs=jax.device_put(cheb.coeffs, NamedSharding(mesh, P(None, None, "x", "y"))),
            lo_u=jax.device_put(cheb.lo_u, rep),
            hi_u=jax.device_put(cheb.hi_u, rep),
            lo_v=jax.device_put(cheb.lo_v, rep),
            hi_v=jax.device_put(cheb.hi_v, rep),
        )
    init_flow = problem.init_flow
    if init_flow is not None:
        init_flow = jax.device_put(init_flow, NamedSharding(mesh, P("x", "y", None)))
    grad_tabs = problem.grad_tabs
    if grad_tabs is not None:
        grad_tabs = tuple(jax.device_put(t, rep) for t in grad_tabs)
    return Problem(
        I1=jax.device_put(problem.I1, rep),
        I2_tab=jax.device_put(problem.I2_tab, rep),
        interior=jax.device_put(problem.interior, NamedSharding(mesh, P("x", "y"))),
        rng=problem.rng,
        cheb=cheb,
        init_flow=init_flow,
        grad_tabs=grad_tabs,
    )


def shard_state(state: GQState, mesh: Mesh, batched: bool = False) -> GQState:
    shardings = state_sharding(mesh, batched)
    return jax.tree_util.tree_map(jax.device_put, state, shardings)


def make_sharded_sweep(cfg: GQMAPConfig, image_shape, mesh: Mesh):
    """jit-compiled sweep with the lattice block-sharded over (x, y)."""
    sweep = make_sweep(cfg, image_shape, sharded=True)
    sh = state_sharding(mesh, batched=False)
    return jax.jit(sweep, in_shardings=(problem_sharding(mesh, cfg), sh))


def make_batched_sharded_sweep(cfg: GQMAPConfig, image_shape, mesh: Mesh):
    """vmapped sweep: leading batch axis sharded over dp, lattice over (x, y).

    This is the full parallelism stack — DP over sequences x 2-D spatial
    decomposition — in one jitted program.
    """
    sweep = make_sweep(cfg, image_shape, sharded=True)
    vsweep = jax.vmap(sweep, in_axes=(None, 0))
    sh = state_sharding(mesh, batched=True)
    return jax.jit(vsweep, in_shardings=(problem_sharding(mesh, cfg), sh))


def stack_states(states: list[GQState]) -> GQState:
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *states)
