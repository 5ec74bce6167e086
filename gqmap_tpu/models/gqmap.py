"""The GQMAP variational inference engine (single-program XLA sweep).

Rebuilds the reference solvers — ``gqmap_gpu_mixture.m`` (full-res mixture)
and ``gqmap_gpuSuper_mix_entropy.m`` (quarter-res super lattice + entropy
annealing) — as one configurable, jit-compiled synchronous-Jacobi engine:

* per sweep, node and edge quadrature gradients are computed for the whole
  (M, N, L) lattice in one traced XLA program (the reference's two
  ``arrayfun`` kernel launches, ``gqmap_gpu_mixture.m:29-34``);
* neighbor gather/scatter uses ``jnp.roll`` (== ``circshift``), which XLA's
  SPMD partitioner lowers to collective-permutes when the lattice is
  sharded over a device mesh;
* sweeps run in on-device segments (``lax.while_loop``) between host
  evaluation points, amortizing dispatch over the eval cadence
  (``mod(it,300)`` — ``gqmap_gpu_mixture.m:52``) and honoring the
  reference's early-stop rule ``it > its || mean|dmu| < tor`` (``:75``).
"""

from __future__ import annotations

import dataclasses
import math

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FlowRange, GQMAPConfig
from ..ops.gq import EDGE, NODE, finalize, gq_accumulate, gq_accumulate_diff, gq_ei, gq_ei_diff
from ..ops.interp import pad_cubic, upsample_cubic
from ..ops.mixture import extract_map
from ..ops.potentials import make_edge_pot, make_node_pot_bicubic, make_node_pot_nearest
from ..ops.quadrature import build_table, build_table_1d
from ..ops.simplex import project_simplex, softmax, softmax_natural_step

_E_CONST1 = 1.0 + math.log(2.0 * math.pi)
_INV_PI = 1.0 / math.pi

__all__ = [
    "DistHooks",
    "GQState",
    "Problem",
    "SweepAux",
    "SolveResult",
    "init_state",
    "make_problem",
    "make_sweep",
    "make_segment_runner",
    "make_map_fn",
    "make_logp_fn",
    "aepe_of",
    "solve",
]


class GQState(NamedTuple):
    """Variational state: one bivariate Gaussian per (pixel, component) plus
    per-edge correlations and global mixture logits
    (``gqmap_gpu_mixture.m:18-24``)."""

    w: jnp.ndarray        # (L,) mixture logits (or weights for projsplx mode)
    muu: jnp.ndarray      # (L, M, N)   [lattice axes trail]
    muv: jnp.ndarray      # (L, M, N)
    sigmau: jnp.ndarray   # (L, M, N)
    sigmav: jnp.ndarray   # (L, M, N)
    pn: jnp.ndarray       # (L, M, N) node (u,v) correlation
    rou: jnp.ndarray      # (2, 2, L, M, N) edge corr [direction, channel]
    temperature: jnp.ndarray  # scalar annealed T
    it: jnp.ndarray       # scalar int32, 1-based iteration about to run


class Problem(NamedTuple):
    """Per-run constants living on device.

    Everything a sweep reads besides the state must be HERE (a jit
    argument): arrays captured by closure become embedded HLO constants,
    which blow up compile times.
    """

    I1: jnp.ndarray       # (Mo, No) frame 1 grayscale
    I2_tab: jnp.ndarray   # pad_cubic(I2) or upsample_cubic(I2, rfc)
    interior: jnp.ndarray # (M, N) bool: updatable lattice sites
    rng: FlowRange
    cheb: object = None   # ChebData for data_term="chebyshev"
    init_flow: object = None  # (M, N, 2) prior flow for data_term="quadratic"
    grad_tabs: object = None  # (I2u_tab, I2v_tab) upsampled Prewitt gradient
                              # fields for gradient_estimator="prewitt"


class SweepAux(NamedTuple):
    energy: jnp.ndarray
    ptdmu: jnp.ndarray
    ptdsigma: jnp.ndarray


def _dt(cfg: GQMAPConfig):
    return jnp.dtype(cfg.dtype)


def flow_lattice_shape(cfg: GQMAPConfig, image_shape) -> tuple[int, int]:
    Mo, No = image_shape
    if Mo % cfg.patch or No % cfg.patch:
        raise ValueError(
            f"image shape {image_shape} not divisible by patch={cfg.patch}"
        )
    return Mo // cfg.patch, No // cfg.patch


def use_kernel(setting: str, field: str, sharded: bool) -> bool:
    """Whether a sweep runs a Pallas kernel (``True``) or XLA's path.

    ``setting`` is the config's ``"auto" | "xla" | "pallas"``. The kernels
    are Triton kernels for the GPU. They run on a GPU backend whenever the
    sweep is not GSPMD-sharded (``sharded``): a Pallas call is opaque to
    GSPMD's partitioner, whereas inside a ``shard_map`` body every array
    is already the local block. An explicit ``"pallas"`` where no kernel
    can run raises instead of falling back.
    """
    if setting not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown {field} {setting!r}")
    if setting == "xla":
        return False
    available = jax.default_backend() == "gpu" and not sharded
    if setting == "pallas" and not available:
        raise ValueError(
            f"{field}='pallas' needs an unsharded sweep on a GPU backend "
            f"(backend {jax.default_backend()!r}, sharded={sharded})"
        )
    return available


def make_problem(cfg: GQMAPConfig, I1, I2, flow_range: FlowRange | None = None) -> Problem:
    dt = _dt(cfg)
    I1 = jnp.asarray(I1, dt)
    I2 = jnp.asarray(I2, dt)
    if cfg.window_rg > 0 and cfg.patch > 1:
        raise ValueError("window_rg and patch > 1 are mutually exclusive")
    if cfg.gradient_estimator == "prewitt" and cfg.data_term != "nearest":
        raise ValueError("gradient_estimator='prewitt' requires data_term='nearest'")
    cheb = None
    if cfg.data_term == "bicubic":
        tab = pad_cubic(I2)
    elif cfg.data_term == "nearest":
        tab = upsample_cubic(I2, cfg.rfc)
    elif cfg.data_term == "quadratic":
        tab = pad_cubic(I2)  # kept for logP evaluation
    elif cfg.data_term == "chebyshev":
        tab = pad_cubic(I2)
        if flow_range is None:
            raise ValueError("data_term='chebyshev' needs flow_range at make_problem")
        from ..ops.chebyshev import build_cheb_data

        m = cfg.cheb_margin
        box = (flow_range.minu - m, flow_range.maxu + m,
               flow_range.minv - m, flow_range.maxv + m)
        cheb = build_cheb_data(I1, tab, cfg.lambdad, cfg.epsn, box,
                               P=cfg.cheb_p, Q=cfg.cheb_q, patch=cfg.patch,
                               window_rg=cfg.window_rg, pack=cfg.bicubic_pack)
    elif cfg.data_term == "cosine":
        tab = pad_cubic(I2)
        if flow_range is None:
            raise ValueError("data_term='cosine' needs flow_range at make_problem")
        from ..ops.cosine import build_cos_data

        m = cfg.cheb_margin
        box = (flow_range.minu - m, flow_range.maxu + m,
               flow_range.minv - m, flow_range.maxv + m)
        cheb = build_cos_data(I1, tab, cfg.lambdad, cfg.epsn, box,
                              A=cfg.cheb_p, B=cfg.cheb_q, patch=cfg.patch,
                              window_rg=cfg.window_rg, pack=cfg.bicubic_pack)
    else:
        raise ValueError(f"unknown data_term {cfg.data_term!r}")
    grad_tabs = None
    if cfg.gradient_estimator == "prewitt":
        from ..ops.interp import prewitt_gradients

        Gx, Gy = prewitt_gradients(I2)
        grad_tabs = (upsample_cubic(Gx, cfg.rfc), upsample_cubic(Gy, cfg.rfc))
    M, N = flow_lattice_shape(cfg, I1.shape)
    interior = jnp.asarray(_interior_mask(M, N, cfg.border))
    return Problem(I1=I1, I2_tab=tab, interior=interior, rng=flow_range, cheb=cheb,
                   grad_tabs=grad_tabs)


def init_state(cfg: GQMAPConfig, rng: FlowRange, image_shape, seed=None) -> GQState:
    """Random init mirroring ``gqmap_gpu_mixture.m:18-24`` (uniforms over the
    GT-derived flow range; large sigma init; zero correlations)."""
    dt = _dt(cfg)
    M, N = flow_lattice_shape(cfg, image_shape)
    L = cfg.L
    key = jax.random.PRNGKey(cfg.seed if seed is None else seed)
    kw, ku, kv, ksu, ksv = jax.random.split(key, 5)
    du = rng.maxu - rng.minu
    dv = rng.maxv - rng.minv
    w0 = jax.random.uniform(kw, (L,), dt)
    if cfg.alpha_update != "softmax_natural":
        w0 = softmax(w0)  # projsplx mode stores the weights themselves
    return GQState(
        w=w0,
        muu=rng.minu + jax.random.uniform(ku, (L, M, N), dt) * du,
        muv=rng.minv + jax.random.uniform(kv, (L, M, N), dt) * dv,
        sigmau=jax.random.uniform(ksu, (L, M, N), dt) + du,
        sigmav=jax.random.uniform(ksv, (L, M, N), dt) + dv,
        pn=jnp.zeros((L, M, N), dt),
        rou=jnp.zeros((2, 2, L, M, N), dt),
        temperature=jnp.asarray(cfg.temperature, dt),
        it=jnp.asarray(1, jnp.int32),
    )


def _interior_mask(M: int, N: int, border: int):
    m = np.zeros((M, N), bool)
    m[border : M - border, border : N - border] = True
    return m


def _node_f(cfg: GQMAPConfig, problem: Problem, origin=None, local_image_shape=None):
    # The spectral terms (cosine/chebyshev) and the quadratic prior are
    # strictly per-site over per-site constants (the coefficient field /
    # init flow), so on the shard_map halo path they need NO origin handling:
    # the local block of problem.cheb / problem.init_flow arrives pre-sliced
    # by the lattice PartitionSpec (parallel/halo.py, parallel/sharded.py).
    if cfg.data_term == "cosine":
        return None  # closed-form path: no per-sample potential callable
    if cfg.data_term == "quadratic":
        from ..ops.potentials import make_node_pot_quadratic

        return make_node_pot_quadratic(problem.init_flow, cfg.quad_var)
    if cfg.data_term == "chebyshev":
        from ..ops.chebyshev import make_node_pot_chebyshev

        return make_node_pot_chebyshev(problem.cheb, cfg.cheb_ablock)
    if cfg.window_rg > 0:
        from ..ops.potentials import make_node_pot_windowed

        return make_node_pot_windowed(
            problem.I1, problem.I2_tab, cfg.lambdad, cfg.epsn,
            cfg.window_rg, cfg.data_term, cfg.rfc,
            origin=origin, local_image_shape=local_image_shape,
            pack=cfg.bicubic_pack,
        )
    if cfg.data_term == "bicubic":
        return make_node_pot_bicubic(
            problem.I1, problem.I2_tab, cfg.lambdad, cfg.epsn, patch=cfg.patch,
            origin=origin, local_image_shape=local_image_shape,
            pack=cfg.bicubic_pack,
        )
    return make_node_pot_nearest(
        problem.I1, problem.I2_tab, cfg.lambdad, cfg.epsn, cfg.rfc,
        origin=origin, local_image_shape=local_image_shape,
    )


class DistHooks(NamedTuple):
    """Hooks that turn the single-device sweep into a shard_map body.

    ``roll(x, shift, axis)`` must implement the *global* circshift over the
    sharded lattice (explicit halo exchange); ``psum`` the all-device sum of
    scalars/small vectors; ``origin()`` the image-pixel offset of this
    shard; ``local_lattice`` its owned lattice extent.
    """

    roll: Callable
    psum: Callable
    origin: Callable
    local_lattice: tuple


def make_sweep(
    cfg: GQMAPConfig, image_shape, dist: "DistHooks | None" = None,
    sharded: bool = False,
) -> Callable[[Problem, GQState], tuple[GQState, SweepAux]]:
    """Build the jit-able single-sweep update (one synchronous Jacobi step).

    ``image_shape`` fixes the lattice geometry; the per-run constants
    (frames, flow range) are passed at call time as a :class:`Problem` so
    they stay jit *arguments* — closing over concrete device arrays would
    bake them into the compiled HLO as giant constants. ``sharded`` says the
    sweep will be jitted over GSPMD-sharded arrays (see :func:`use_kernel`).
    """
    dt = _dt(cfg)
    M, N = flow_lattice_shape(cfg, image_shape)
    L = cfg.L
    b = cfg.border
    tab = build_table(cfg.K, cfg.quad_chunk, dt)
    if cfg.edge_kind == "truncquad":
        from ..ops.potentials import make_edge_pot_truncquad, make_edge_pot_truncquad_diff

        edge_f = make_edge_pot_truncquad(cfg.gama, cfg.dta)
        edge_fd = make_edge_pot_truncquad_diff(cfg.gama, cfg.dta)
    else:
        from ..ops.potentials import make_edge_pot_diff

        edge_f = make_edge_pot(cfg.lambdas, cfg.epsn)
        edge_fd = make_edge_pot_diff(cfg.lambdas, cfg.epsn)
    if cfg.edge_quad == "reduced":
        k1 = cfg.edge_quad_k if cfg.edge_quad_k > 0 else 2 * cfg.K + 3
        tab1 = build_table_1d(k1, dtype=dt)
    elif cfg.edge_quad != "tensor":
        raise ValueError(f"unknown edge_quad {cfg.edge_quad!r}")
    n_interior = (M - 2 * b) * (N - 2 * b) * L
    softmax_mode = cfg.alpha_update == "softmax_natural"
    if cfg.gradient_estimator not in ("stein", "autodiff", "prewitt"):
        raise ValueError(f"unknown gradient_estimator {cfg.gradient_estimator!r}")

    roll = dist.roll if dist is not None else jnp.roll
    psum = dist.psum if dist is not None else (lambda x: x)

    # Kernel choice is trace-time (use_kernel). The autodiff estimator
    # differentiates the XLA expectation, so it never takes a kernel; the
    # edge kernel covers the reduced Charbonnier rule.
    use_node_kernel = (
        cfg.data_term == "cosine"
        and cfg.gradient_estimator != "autodiff"
        and use_kernel(cfg.node_kernel, "node_kernel", sharded)
    )
    use_edge_kernel = (
        cfg.edge_quad == "reduced"
        and cfg.edge_kind == "charbonnier"
        and cfg.gradient_estimator != "autodiff"
        and use_kernel(cfg.edge_kernel, "edge_kernel", sharded)
    )

    def sweep(problem: Problem, state: GQState) -> tuple[GQState, SweepAux]:
        if dist is None:
            node_f = _node_f(cfg, problem)
        else:
            ml, nl = dist.local_lattice
            r0, c0 = dist.origin()
            node_f = _node_f(
                cfg, problem,
                origin=(r0 * cfg.patch, c0 * cfg.patch),
                local_image_shape=(ml * cfg.patch, nl * cfg.patch),
            )
        rngv = problem.rng
        interior = problem.interior  # (M, N), broadcasts left
        it_f = state.it.astype(dt)
        if cfg.step_const:
            step = jnp.asarray(cfg.step0, dt)
        else:
            step = jnp.asarray(cfg.step0, dt) / (1.0 + it_f / jnp.asarray(cfg.step_tau, dt))
        alpha = softmax(state.w) if softmax_mode else state.w
        a3 = alpha.reshape(L, 1, 1)
        T = state.temperature

        def compute_grads(state: GQState):
            """All parameter gradients + interior energy/dalpha at ``state``.

            Factored out of the update so the red-black (checkerboard
            Gauss-Seidel) order can evaluate it once per half-step against
            the other color's freshly updated values (SURVEY.md §2.5); the
            Jacobi order calls it exactly once per sweep, reproducing the
            reference dataflow (gqmap_gpu_mixture.m:29-46) unchanged.
            """
            if cfg.gradient_estimator == "autodiff":
                # Vectorized heir of the legacy/gqmap_gpuV3.m analytic-derivative
                # estimator family: all parameter gradients (incl. the neighbor
                # scatter-back and the softmax chain) via jax.grad of the
                # quadrature-estimated expected energy.
                # Gradient target: the FULL-lattice energy (incl. border-owned
                # and wrap-around edge terms) — that is what the reference's
                # assembled gradients differentiate; the interior-only sum is
                # only what it *reports* and what drives the alpha update
                # (gqmap_gpu_mixture.m:36,48 vs :37-46).
                def expected_energy(muu_, muv_, su_, sv_, pn_, rou_):
                    a3_ = alpha.reshape(L, 1, 1)
                    if cfg.data_term == "cosine":
                        from ..ops.cosine import cos_ei

                        en = cos_ei(problem.cheb, muu_, muv_, su_, sv_, pn_, cfg.cheb_ablock)
                    else:
                        en = gq_ei(node_f, muu_, muv_, su_, sv_, pn_, tab) * _INV_PI
                    Hn = _E_CONST1 + jnp.log(jnp.sqrt(1.0 - pn_ * pn_) * su_ * sv_)
                    da_n = en - 3.0 * T * Hn
                    mu_ = jnp.stack([muu_, muv_], axis=0)
                    sg_ = jnp.stack([su_, sv_], axis=0)
                    u2e_ = jnp.stack([roll(mu_, -1, -2), roll(mu_, -1, -1)], axis=0)
                    o2e_ = jnp.stack([roll(sg_, -1, -2), roll(sg_, -1, -1)], axis=0)
                    if cfg.edge_quad == "reduced":
                        ei_e = gq_ei_diff(edge_fd, mu_[None], u2e_, sg_[None], o2e_, rou_, tab1)
                    else:
                        ei_e = gq_ei(edge_f, mu_[None], u2e_, sg_[None], o2e_, rou_, tab)
                    He = _E_CONST1 + jnp.log(jnp.sqrt(1.0 - rou_ * rou_) * sg_[None] * o2e_)
                    da_e = ei_e * _INV_PI + T * He
                    full = psum(jnp.sum(a3_ * da_n) + jnp.sum(a3_ * da_e))
                    energy_int = psum(
                        jnp.sum(jnp.where(interior, a3_ * da_n, 0))
                        + jnp.sum(jnp.where(interior, a3_ * da_e, 0))
                    )
                    dalpha_int = psum(
                        jnp.sum(jnp.where(interior, da_n, 0), axis=(-2, -1))
                        + jnp.sum(jnp.where(interior, da_e, 0), axis=(0, 1, -2, -1))
                    )
                    return full, (energy_int, dalpha_int)

                (_, (energy, dalpha)), grads = jax.value_and_grad(
                    expected_energy, argnums=tuple(range(6)), has_aux=True
                )(state.muu, state.muv, state.sigmau, state.sigmav, state.pn, state.rou)
                dmuu, dmuv, dsigmau, dsigmav, dpn_g, drou_g = grads
            else:
                # --- node kernel (gqmap_gpu_mixture.m:29, :87-116) ---
                if cfg.gradient_estimator == "prewitt":
                    # the gpuV3 estimator family: quadrature of the chain-rule
                    # df/dx against precomputed Prewitt gradient fields
                    # (legacy/gqmap_gpuV3.m:91-125)
                    from ..ops.gq import finalize_chain, gq_accumulate_chain
                    from ..ops.potentials import make_node_pot_nearest_chain

                    if dist is None:
                        chain_kw = {}
                    else:
                        ml, nl = dist.local_lattice
                        r0, c0 = dist.origin()
                        chain_kw = dict(origin=(r0, c0), local_image_shape=(ml, nl))
                    fgn = make_node_pot_nearest_chain(
                        problem.I1, problem.I2_tab, problem.grad_tabs[0],
                        problem.grad_tabs[1], cfg.lambdad, cfg.epsn, cfg.rfc,
                        **chain_kw,
                    )
                    raw_c = gq_accumulate_chain(
                        fgn, state.muu, state.muv, state.sigmau, state.sigmav,
                        state.pn, tab,
                    )
                    gn = finalize_chain(raw_c, a3, state.sigmau, state.sigmav,
                                        state.pn, T, NODE)
                elif cfg.data_term == "cosine":
                    if use_node_kernel:
                        from ..kernels.cosine_gq import cos_node_grads_pallas

                        # cfg.cheb_ablock is the XLA scan's u-block size; the
                        # kernel loops over every u-degree inside a program.
                        gn = cos_node_grads_pallas(
                            problem.cheb, state.muu, state.muv, state.sigmau,
                            state.sigmav, state.pn, a3, T, NODE,
                        )
                    else:
                        from ..ops.cosine import cos_node_grads

                        gn = cos_node_grads(
                            problem.cheb, state.muu, state.muv, state.sigmau,
                            state.sigmav, state.pn, a3, T, NODE, cfg.cheb_ablock,
                        )
                else:
                    raw_n = gq_accumulate(
                        node_f, state.muu, state.muv, state.sigmau, state.sigmav, state.pn, tab
                    )
                    gn = finalize(raw_n, a3, state.sigmau, state.sigmav, state.pn, T, NODE)

                # --- edge kernel (:31-34, :118-146); dims (dir, chan, L, M, N) ---
                mu = jnp.stack([state.muu, state.muv], axis=0)        # (chan, L, M, N)
                sg = jnp.stack([state.sigmau, state.sigmav], axis=0)
                u1e = mu[None]                                        # (1, chan, L, M, N)
                o1e = sg[None]
                u2e = jnp.stack([roll(mu, -1, -2), roll(mu, -1, -1)], axis=0)
                o2e = jnp.stack([roll(sg, -1, -2), roll(sg, -1, -1)], axis=0)
                if use_edge_kernel:
                    from ..kernels.edge_reduced_gq import edge_reduced_grads_pallas

                    ge = edge_reduced_grads_pallas(
                        mu, sg, u2e, o2e, state.rou, alpha, T,
                        k1, cfg.lambdas, cfg.epsn, EDGE,
                    )
                elif cfg.edge_quad == "reduced":
                    raw_e = gq_accumulate_diff(edge_fd, u1e, u2e, o1e, o2e, state.rou, tab1)
                    ge = finalize(raw_e, a3, o1e, o2e, state.rou, T, EDGE)
                else:
                    raw_e = gq_accumulate(edge_f, u1e, u2e, o1e, o2e, state.rou, tab)
                    ge = finalize(raw_e, a3, o1e, o2e, state.rou, T, EDGE)

                # --- gradient assembly: endpoint-1 terms stay, endpoint-2 terms
                # are scattered back to the neighbor that owns them (:37-40) ---
                def assemble(dn, d1, d2, chan):
                    return (
                        dn
                        + d1[0, chan]
                        + d1[1, chan]
                        + roll(d2[0, chan], 1, -2)
                        + roll(d2[1, chan], 1, -1)
                    )

                dmuu = assemble(gn.du1, ge.du1, ge.du2, 0)
                dmuv = assemble(gn.du2, ge.du1, ge.du2, 1)
                dsigmau = assemble(gn.do1, ge.do1, ge.do2, 0)
                dsigmav = assemble(gn.do2, ge.do1, ge.do2, 1)
                dpn_g = gn.dp
                drou_g = ge.dp

                # --- energy + global mixture gradient (:36, :48) ---
                energy = psum(
                    jnp.sum(jnp.where(interior, gn.E, 0)) + jnp.sum(jnp.where(interior, ge.E, 0))
                )
                dalpha = psum(
                    jnp.sum(jnp.where(interior, gn.da, 0), axis=(-2, -1))
                    + jnp.sum(jnp.where(interior, ge.da, 0), axis=(0, 1, -2, -1))
                )

            return dmuu, dmuv, dsigmau, dsigmav, dpn_g, drou_g, energy, dalpha

        # --- clamped ascent over a site mask (:41-46) ---
        sstep = step * jnp.asarray(cfg.sigma_step_scale, dt)

        def one_pass(st: GQState, mask):
            dmuu, dmuv, dsigmau, dsigmav, dpn_g, drou_g, energy, dalpha = (
                compute_grads(st)
            )

            def upd(x, dx, lo, hi, s=step):
                return jnp.where(mask, jnp.clip(x + dx * s, lo, hi), x)

            st2 = st._replace(
                muu=upd(st.muu, dmuu, rngv.minu, rngv.maxu),
                muv=upd(st.muv, dmuv, rngv.minv, rngv.maxv),
                sigmau=upd(st.sigmau, dsigmau, cfg.sigma_min, cfg.sigma_max, sstep),
                sigmav=upd(st.sigmav, dsigmav, cfg.sigma_min, cfg.sigma_max, sstep),
                rou=upd(st.rou, drou_g, -cfg.corr_tor, cfg.corr_tor),
                pn=upd(st.pn, dpn_g, -cfg.corr_tor, cfg.corr_tor),
            )
            dmu_sum = psum(jnp.sum(jnp.where(mask, jnp.abs(dmuu), 0)))
            dsig_sum = psum(jnp.sum(jnp.where(mask, jnp.abs(dsigmau), 0)))
            return st2, energy, dalpha, dmu_sum, dsig_sum

        if cfg.sweep_order == "redblack":
            # checkerboard Gauss-Seidel: two half-steps, parity taken in
            # GLOBAL lattice coordinates so the order is shard-invariant
            # (each half gathers neighbors from the CURRENT state via roll,
            # so the halo path naturally exchanges per half-step). Energy /
            # dalpha are reported from the second half (the fresher state).
            ri = jax.lax.broadcasted_iota(jnp.int32, interior.shape, 0)
            ci = jax.lax.broadcasted_iota(jnp.int32, interior.shape, 1)
            if dist is not None:
                r0, c0 = dist.origin()
                ri = ri + r0
                ci = ci + c0
            red = ((ri + ci) & 1) == 0
            st1, _, _, p1, s1_ = one_pass(state, interior & red)
            stc, energy, dalpha, p2, s2_ = one_pass(st1, interior & ~red)
            dmu_sum = p1 + p2
            dsig_sum = s1_ + s2_
        elif cfg.sweep_order == "jacobi":
            stc, energy, dalpha, dmu_sum, dsig_sum = one_pass(state, interior)
        else:
            raise ValueError(f"unknown sweep_order {cfg.sweep_order!r}")

        # --- mixture-weight update, active after alpha_start iters (:50) ---
        if L > 1:
            lr = step * jnp.asarray(cfg.alpha_lr_scale, dt)
            if softmax_mode:
                w_new = softmax_natural_step(state.w, dalpha, lr)
            else:
                w_new = project_simplex(state.w + dalpha * lr)
            w = jnp.where(state.it > cfg.alpha_start, w_new, state.w)
        else:
            w = state.w

        # --- diagnostics & annealing (:69-73) ---
        ptdmu = dmu_sum / n_interior
        ptdsigma = dsig_sum / n_interior
        if cfg.anneal_every > 0:
            T = jnp.where(
                state.it % cfg.anneal_every == 0,
                jnp.maximum(T * jnp.asarray(cfg.drate, dt), jnp.asarray(cfg.t_floor, dt)),
                T,
            )

        new = stc._replace(w=w, temperature=T, it=state.it + 1)
        return new, SweepAux(energy=energy, ptdmu=ptdmu, ptdsigma=ptdsigma)

    return sweep


def make_segment_runner(cfg: GQMAPConfig, image_shape, mesh=None):
    """On-device multi-sweep runner with the reference's early stop.

    Runs up to ``limit`` sweeps (bounded by the eval cadence), recording the
    per-iteration Energy and mean-|dmu| traces; stops as soon as
    ``it > its`` or ``ptdmu < tor`` (``gqmap_gpu_mixture.m:75``).
    Returns ``(state, n_done, energy_buf, ptdmu_buf, ptdsigma_buf, stopped)``.

    With ``mesh`` given, the whole segment is jitted with the lattice
    block-sharded over the mesh's (x, y) axes (GSPMD inserts the halo
    collectives and psums).
    """
    # Sharding comes from the argument placement (shard_state /
    # shard_problem in solve()); jit propagates it, GSPMD partitions.
    sweep = make_sweep(cfg, image_shape, sharded=mesh is not None)
    cap = cfg.eval_every
    dt = _dt(cfg)

    @jax.jit
    def seg(problem: Problem, state: GQState, limit):
        ebuf = jnp.zeros((cap,), dt)
        pbuf = jnp.zeros((cap,), dt)
        sbuf = jnp.zeros((cap,), dt)

        def cond(c):
            _, n, _, _, _, stop = c
            return (n < limit) & (~stop)

        def body(c):
            st, n, eb, pb, sb, _ = c
            st2, aux = sweep(problem, st)
            eb = eb.at[n].set(aux.energy)
            pb = pb.at[n].set(aux.ptdmu)
            sb = sb.at[n].set(aux.ptdsigma)
            stop = (aux.ptdmu < cfg.tor) | (st2.it > cfg.its)
            return (st2, n + 1, eb, pb, sb, stop)

        init = (state, jnp.asarray(0, jnp.int32), ebuf, pbuf, sbuf, jnp.asarray(False))
        st, n, eb, pb, sb, stop = jax.lax.while_loop(cond, body, init)
        return st, n, eb, pb, sb, stop

    return seg


def make_map_fn(cfg: GQMAPConfig):
    """MAP readout: mixture mode per pixel/channel (``:53-58``)."""

    @jax.jit
    def map_fn(state: GQState):
        alpha = softmax(state.w) if cfg.alpha_update == "softmax_natural" else state.w
        return extract_map(alpha, state.muu, state.sigmau, state.muv, state.sigmav)

    return map_fn


def make_logp_fn(cfg: GQMAPConfig, image_shape):
    """True unnormalized log-posterior at a flow field (``:148-154``;
    super variant sums node potentials over each 4x4 patch, ``node_lp``)."""
    edge_f = make_edge_pot(cfg.lambdas, cfg.epsn)

    lp_cfg = cfg
    if cfg.data_term in ("chebyshev", "cosine", "quadratic"):
        lp_cfg = dataclasses.replace(cfg, data_term="bicubic")

    @jax.jit
    def logp(problem: Problem, flow):
        node_f = _node_f(lp_cfg, problem)
        interior = problem.interior
        us = flow[..., 0]
        vs = flow[..., 1]
        npv = node_f(us, vs)
        uv = jnp.moveaxis(flow, -1, 0)  # (chan, M, N)
        ep_v = edge_f(uv, jnp.roll(uv, -1, -2))
        ep_h = edge_f(uv, jnp.roll(uv, -1, -1))
        return (
            jnp.sum(jnp.where(interior, npv, 0))
            + jnp.sum(jnp.where(interior, ep_v + ep_h, 0))
        )

    return logp


def aepe_of(cfg: GQMAPConfig, map_flow, tflow, unknown) -> float:
    """Average endpoint error with the reference's masking/cropping.

    Full-res: unknown-GT pixels zeroed, 1-px border excluded
    (``gqmap_gpu_mixture.m:63-64``). Super: MAP upsampled by ``repelem``
    then 4-px border crop (``gqmap_gpuSuper_mix_entropy.m:58-63``).
    """
    flow = np.asarray(map_flow, np.float64)
    if cfg.patch > 1:
        flow = np.repeat(np.repeat(flow, cfg.patch, 0), cfg.patch, 1)
    flow = flow.copy()
    flow[np.asarray(unknown)] = 0.0
    t = np.asarray(tflow, np.float64)
    c = cfg.border if cfg.patch == 1 else cfg.patch
    sl = np.s_[c:-c, c:-c]
    d = t[sl] - flow[sl]
    return float(np.mean(np.sqrt((d * d).sum(-1))))


@dataclasses.dataclass
class SolveResult:
    mu: np.ndarray        # (M, N, L, 2) means, cat of (muu, muv)
    sigma: np.ndarray     # (M, N, L, 2)
    alpha: np.ndarray     # (L,)
    AEPE: np.ndarray      # (its,) NaN off the eval cadence
    Energy: np.ndarray    # (its,)
    logP: np.ndarray      # (its,) NaN off the eval cadence
    map: np.ndarray       # (M, N, 2) final extracted MAP flow
    best_aepe: float
    iters: int
    state: GQState


def solve(
    cfg: GQMAPConfig,
    I1,
    I2,
    gt_flow=None,
    flow_range: FlowRange | None = None,
    seed=None,
    out_dir=None,
    verbose: bool = False,
    callback=None,
    init: GQState | None = None,
    init_flow=None,
    checkpoint_path=None,
    checkpoint_every: int = 0,
    resume: bool = False,
    mesh=None,
    reset_at: int | None = None,
) -> SolveResult:
    """Run the full GQMAP inference loop (entry points A/B of SURVEY.md §3).

    ``gt_flow`` (raw .flo contents) drives the clamp ranges, unknown mask
    and AEPE exactly like the driver scripts (``optical_flow.m:12-13``);
    pass ``flow_range`` explicitly to run without ground truth.

    With ``mesh`` set (a ``jax.sharding.Mesh`` with x/y axes) the lattice is
    block-sharded and the sweeps run SPMD over the mesh devices.

    Checkpointing: with ``checkpoint_path`` set, the full state is written
    every ``checkpoint_every`` iterations (0 = only at the end); with
    ``resume=True`` an existing checkpoint restarts the run mid-schedule
    (exact state, iteration counter and annealed temperature).

    ``init_flow`` (an (M, N, 2) array, e.g. from the block-matching
    initializer) seeds the means of every mixture component while keeping
    the random sigma init (``legacy/optical_flow_temp.m:33`` +
    ``legacy/gqmap_gpuV2.m:13-14``'s xini hook). ``reset_at`` applies the
    reference's ``reset_para`` divergence-recovery hook after that many
    sweeps: sigma re-widened to half the flow range, correlations zeroed,
    the iteration counter (hence the step/eval schedule) restarted, means
    kept (``legacy/gqmap_gpuV2.m:51-62``).
    """
    import os

    from ..ops.flowviz import flow_to_color

    tflow = unknown = None
    if gt_flow is not None:
        fc = flow_to_color(np.asarray(gt_flow))
        tflow, unknown = fc.flo, fc.unknown
        if flow_range is None:
            flow_range = FlowRange(fc.minu, fc.maxu, fc.minv, fc.maxv)
    if flow_range is None:
        raise ValueError("need gt_flow or flow_range")

    problem = make_problem(cfg, I1, I2, flow_range)
    resumed_extras = {}
    if resume and checkpoint_path is not None and os.path.exists(checkpoint_path):
        from ..utils.checkpoint import load_checkpoint

        state, _, resumed_extras = load_checkpoint(checkpoint_path, expect_cfg=cfg)
    elif init is not None:
        state = init
    else:
        state = init_state(cfg, flow_range, np.shape(I1), seed)
        if init_flow is not None:
            fl = jnp.asarray(init_flow, _dt(cfg))
            if fl.shape[:2] != state.muu.shape[1:]:
                raise ValueError(
                    f"init_flow shape {fl.shape} does not match the flow "
                    f"lattice {state.muu.shape[1:]}"
                )
            state = state._replace(
                muu=jnp.broadcast_to(
                    jnp.clip(fl[..., 0], flow_range.minu, flow_range.maxu)[None],
                    state.muu.shape,
                ),
                muv=jnp.broadcast_to(
                    jnp.clip(fl[..., 1], flow_range.minv, flow_range.maxv)[None],
                    state.muv.shape,
                ),
            )
    if mesh is not None:
        from ..parallel.sharded import shard_problem, shard_state

        problem = shard_problem(problem, mesh)
        state = shard_state(state, mesh)
    seg = make_segment_runner(cfg, np.shape(I1), mesh=mesh)
    map_fn = make_map_fn(cfg)
    logp_fn = make_logp_fn(cfg, np.shape(I1))

    its = cfg.its
    Energy = np.full(its, np.nan)
    AEPE = np.full(its, np.nan)
    logP = np.full(its, np.nan)
    dmu_trace = np.full(its, np.nan)
    best_aepe = math.inf
    it_done = int(state.it) - 1  # >0 when resuming from a checkpoint
    last_map = None

    # Resume restores the full run context — best-so-far AEPE and the
    # Energy/AEPE/logP/|dmu| traces — so a resumed run returns the identical
    # SolveResult an unbroken run would (the state alone under-reports
    # best_aepe and loses the history).
    if resumed_extras:
        if "best_aepe" in resumed_extras:
            best_aepe = float(resumed_extras["best_aepe"])
        for name, arr in (("AEPE", AEPE), ("Energy", Energy),
                          ("logP", logP), ("dmu", dmu_trace)):
            if name in resumed_extras:
                saved = np.asarray(resumed_extras[name])
                n = min(saved.size, its)
                arr[:n] = saved[:n]

    last_saved = it_done

    def _maybe_checkpoint(force=False):
        nonlocal last_saved
        if checkpoint_path is None:
            return
        if force or (checkpoint_every and it_done - last_saved >= checkpoint_every):
            from ..utils.checkpoint import save_checkpoint

            save_checkpoint(
                checkpoint_path, state, cfg, best_aepe=best_aepe,
                AEPE=AEPE, Energy=Energy, logP=logP, dmu=dmu_trace,
            )
            last_saved = it_done

    def _assert_finite():
        if not cfg.debug_finite:
            return
        for f in state._fields:
            v = np.asarray(getattr(state, f))
            if not np.isfinite(v).all():
                raise FloatingPointError(
                    f"non-finite state leaf {f!r} after sweep {it_done} "
                    f"({np.size(v) - np.isfinite(v).sum()} bad values; "
                    "likely the 1/(1-p^2) blow-up near the correlation clamp)"
                )

    pending_reset = reset_at if reset_at else None

    while it_done < its:
        next_eval = 1 if it_done == 0 else (it_done // cfg.eval_every + 1) * cfg.eval_every
        next_eval = min(next_eval, its)
        if pending_reset is not None:
            next_eval = min(next_eval, pending_reset)
        limit = next_eval - it_done
        state, n, eb, pb, sb, stop = seg(problem, state, limit)
        n = int(n)
        Energy[it_done : it_done + n] = np.asarray(eb)[:n]
        dmu_trace[it_done : it_done + n] = np.asarray(pb)[:n]
        it_done += n
        stopped = bool(stop)
        _assert_finite()

        if n == limit:  # reached the eval iteration
            last_map = np.asarray(map_fn(state))
            lp = float(logp_fn(problem, jnp.asarray(last_map)))
            logP[it_done - 1] = lp
            if tflow is not None:
                aepe = aepe_of(cfg, last_map, tflow, unknown)
                AEPE[it_done - 1] = aepe
                best_aepe = min(best_aepe, aepe)
            if out_dir is not None:
                _write_viz(cfg, last_map, out_dir, it_done)
            if verbose:
                print(
                    f"[{it_done}] dmu={dmu_trace[it_done-1]:.3e} "
                    f"E={Energy[it_done-1]:.6e} AEPE={best_aepe:.4f} logP={lp:.6e}"
                )
            if callback is not None:
                callback(it_done, state, last_map, AEPE[it_done - 1], lp)
        if pending_reset is not None and it_done >= pending_reset:
            # reset_para (legacy/gqmap_gpuV2.m:54-62): re-widen sigma, zero
            # the correlations, restart the schedule; keep mu and best_aepe.
            state = state._replace(
                sigmau=jnp.full_like(state.sigmau, (flow_range.maxu - flow_range.minu) / 2.0),
                sigmav=jnp.full_like(state.sigmav, (flow_range.maxv - flow_range.minv) / 2.0),
                pn=jnp.zeros_like(state.pn),
                rou=jnp.zeros_like(state.rou),
                it=jnp.asarray(1, jnp.int32),
            )
            it_done = 0
            last_saved = 0
            pending_reset = None
            if verbose:
                print("[reset_para] sigma, pn and rou have been reset")
            continue
        _maybe_checkpoint()
        if stopped or it_done >= its:
            break

    _maybe_checkpoint(force=checkpoint_path is not None)
    if last_map is None:
        last_map = np.asarray(map_fn(state))
    alpha = softmax(state.w) if cfg.alpha_update == "softmax_natural" else state.w
    mu_api = np.stack(
        [np.moveaxis(np.asarray(state.muu), 0, -1), np.moveaxis(np.asarray(state.muv), 0, -1)],
        axis=-1,
    )
    sg_api = np.stack(
        [np.moveaxis(np.asarray(state.sigmau), 0, -1), np.moveaxis(np.asarray(state.sigmav), 0, -1)],
        axis=-1,
    )
    return SolveResult(
        mu=mu_api,
        sigma=sg_api,
        alpha=np.asarray(alpha),
        AEPE=AEPE,
        Energy=Energy,
        logP=logP,
        map=last_map,
        best_aepe=best_aepe,
        iters=it_done,
        state=state,
    )


def _write_viz(cfg: GQMAPConfig, map_flow, out_dir, it):
    import os

    import imageio.v2 as imageio

    from ..ops.flowviz import flow_to_color

    os.makedirs(out_dir, exist_ok=True)
    flow = np.asarray(map_flow, np.float64)
    if cfg.patch > 1:
        p = cfg.patch
        flow = np.repeat(np.repeat(flow, p, 0), p, 1)[p:-p, p:-p]
    imageio.imwrite(os.path.join(out_dir, f"{it}.png"), flow_to_color(flow).img)
