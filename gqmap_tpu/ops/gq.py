"""Gauss-quadrature expectation gradients over bivariate Gaussians.

This is the numerical heart of GQMAP: closed-form (Stein-identity) gradients
of ``E_q[f(x1, x2)]`` with respect to the parameters ``(u1, u2, o1, o2, p)``
of a correlated bivariate Gaussian ``q``, estimated with tensor-product
Gauss-Hermite quadrature under the "spectral" whitening transform

    s = (sqrt(1+p) + sqrt(1-p))/2,  t = (sqrt(1+p) - sqrt(1-p))/2,
    z_i = s*XI + t*XJ,              z_j = t*XI + s*XJ,

i.e. the symmetric square root of ``[[1, p], [p, 1]]`` (s^2+t^2 = 1,
2st = p). Reference: ``gqmap_gpu_mixture.m:87-146`` (``node_grad_spectral``
/ ``edge_grad_spectral``); the entropy terms use Bethe counting numbers
(-3T per node, +T per edge on a 4-connected grid, ``:109-115, :139-145``).

Vectorized design: instead of one CUDA thread per lattice site running a
scalar K^2 loop, the whole lattice is updated by a ``lax.scan`` over
quadrature chunks, each step fully vectorized over every site (and mixture
component / edge direction / channel). Only six accumulators are
carried; the per-point integrands are algebraically refactored so that all
``p``-dependent scaling happens once per site in :func:`finalize` rather
than once per quadrature point:

    Ei  = sum_k fv                    Z1  = sum_k fv*z_i
    Z2  = sum_k fv*z_j                Sa  = sum_k fv*(XI^2+XJ^2-1)
    Sm  = sum_k fv*(XI^2-XJ^2)        Sxy = sum_k fv*XI*XJ

    du1_raw = Z1 - p*Z2         do1_raw = Sa + Sm/sqrt(1-p^2)
    du2_raw = Z2 - p*Z1         do2_raw = Sa - Sm/sqrt(1-p^2)
    dp_raw  = -p*Sa + 2*Sxy     (== sum fv*(p - p*(XI^2+XJ^2) + 2*XI*XJ))
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .quadrature import QuadTable, QuadTable1D

__all__ = [
    "GQRaw",
    "GQGrads",
    "GQChainRaw",
    "gq_accumulate",
    "gq_accumulate_chain",
    "gq_accumulate_diff",
    "gq_ei",
    "gq_ei_diff",
    "finalize",
    "finalize_chain",
    "finalize_closed",
    "NODE",
    "EDGE",
]

_SQRT2 = math.sqrt(2.0)
_CONST1 = 1.0 + math.log(2.0 * math.pi)  # 1 + log(2*pi), entropy constant

# Bethe counting-number scale for the temperature terms: node entropy enters
# with coefficient -3T (degree-1 = 3 on the 4-connected interior grid), edge
# entropy with +T. finalize() uses cn = entropy_scale * T with
# entropy_scale = +3 for nodes, -1 for edges.
NODE = 3.0
EDGE = -1.0


class GQRaw(NamedTuple):
    """Raw quadrature sums (see module docstring)."""

    Ei: jnp.ndarray
    Z1: jnp.ndarray
    Z2: jnp.ndarray
    Sa: jnp.ndarray
    Sm: jnp.ndarray
    Sxy: jnp.ndarray


class GQGrads(NamedTuple):
    """Finalized per-site outputs, matching the reference kernel returns."""

    da: jnp.ndarray   # d/d(alpha): expected potential + entropy (per unit weight)
    du1: jnp.ndarray
    du2: jnp.ndarray
    do1: jnp.ndarray
    do2: jnp.ndarray
    dp: jnp.ndarray
    E: jnp.ndarray    # alpha-weighted energy contribution (== a*da)


def gq_accumulate(
    f: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    u1: jnp.ndarray,
    u2: jnp.ndarray,
    o1: jnp.ndarray,
    o2: jnp.ndarray,
    p: jnp.ndarray,
    tab: QuadTable,
    *,
    unroll: int = 1,
) -> GQRaw:
    """Accumulate the six quadrature sums of ``f`` over every site.

    ``f(x1, x2)`` receives sample-point arrays of shape ``(C,) + site_shape``
    (C = quadrature chunk, LEADING axis) and must return the same shape. All
    site arrays broadcast together to ``site_shape``.

    Layout note: the chunk axis leads (and lattice axes trail) so the big
    per-point intermediates keep (M, N) in the minor-most, contiguous
    positions.
    """
    dtype = u1.dtype
    s = (jnp.sqrt(1.0 + p) + jnp.sqrt(1.0 - p)) * 0.5
    t = (jnp.sqrt(1.0 + p) - jnp.sqrt(1.0 - p)) * 0.5
    o1e = o1 * _SQRT2
    o2e = o2 * _SQRT2

    site_shape = jnp.broadcast_shapes(u1.shape, u2.shape, o1.shape, o2.shape, p.shape)
    zeros = jnp.zeros(site_shape, dtype)
    init = GQRaw(zeros, zeros, zeros, zeros, zeros, zeros)

    tabj = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype).reshape((a.shape[0],) + cshape_tail(site_shape, a.shape[1])),
        tab,
    )

    def body(carry: GQRaw, tc) -> tuple[GQRaw, None]:
        xi, xj, wiwj, xixj, x2a, x2m = tc
        zi = s * xi + t * xj            # (C,) + site
        zj = t * xi + s * xj
        x1 = o1e * zi + u1
        x2 = o2e * zj + u2
        fv = wiwj * f(x1, x2)
        new = GQRaw(
            Ei=carry.Ei + jnp.sum(fv, 0),
            Z1=carry.Z1 + jnp.sum(fv * zi, 0),
            Z2=carry.Z2 + jnp.sum(fv * zj, 0),
            Sa=carry.Sa + jnp.sum(fv * (x2a - 1.0), 0),
            Sm=carry.Sm + jnp.sum(fv * x2m, 0),
            Sxy=carry.Sxy + jnp.sum(fv * xixj, 0),
        )
        return new, None

    raw, _ = jax.lax.scan(body, init, tabj, unroll=unroll)
    return raw


def cshape_tail(site_shape, C: int) -> tuple[int, ...]:
    """Shape of one scan-step table slice: ``(C, 1, 1, ...)``."""
    return (C,) + (1,) * len(site_shape)


def gq_accumulate_diff(
    gd: Callable[[jnp.ndarray], jnp.ndarray],
    u1: jnp.ndarray,
    u2: jnp.ndarray,
    o1: jnp.ndarray,
    o2: jnp.ndarray,
    p: jnp.ndarray,
    tab: QuadTable1D,
    *,
    unroll: int = 1,
) -> GQRaw:
    """Difference-reduced quadrature: the six sums for ``f(x1,x2) = gd(x1-x2)``.

    Replacement for the K^2-point tensor rule on *edge* potentials
    (both reference edge families are pure difference potentials:
    ``gqmap_gpu_mixture.m:180-182``, ``legacy/gqmap_cpu.m:42-44``). Under the
    whitened bivariate Gaussian, ``d = x1 - x2 = delta + a*XI + b*XJ`` with

        a = o1e*s - o2e*t,   b = o1e*t - o2e*s,   c = a^2 + b^2,

    so ``d`` is 1-D Gaussian and every accumulated monomial's conditional
    expectation given ``d`` is a quadratic polynomial in ``r = d - delta``:

        E[z_i | r]            = (o1e - p*o2e)/c * r
        E[z_j | r]            = (p*o1e - o2e)/c * r
        E[XI^2+XJ^2 - 1 | r]  = r^2/c - 1/2
        E[XI^2-XJ^2 | r]      = (a^2-b^2)/c * (r^2/c - 1/2),  a^2-b^2 = (o1e^2-o2e^2)*sqrt(1-p^2)
        E[XI*XJ | r]          = ab/c * (r^2/c - 1/2),         ab = p*(o1e^2+o2e^2)/2 - o1e*o2e

    A K-point 1-D rule over ``d`` therefore reproduces the K^2-point tensor
    sums (exactly so whenever the tensor rule integrates its transverse
    direction exactly, i.e. always for these degree-<=2 monomial weights):
    with ``r_k = sqrt(c) x_k``, ``H0 = sum w g``, ``H1 = sum w g x``,
    ``H2 = sum w g (x^2 - 1/2)``,

        Ei  = sqrt(pi) H0                 Sa  = sqrt(pi) H2
        Z1  = sqrt(pi) (o1e - p*o2e)/sqrt(c) H1
        Z2  = sqrt(pi) (p*o1e - o2e)/sqrt(c) H1
        Sm  = sqrt(pi) (o1e^2-o2e^2) sqrt(1-p^2)/c H2
        Sxy = sqrt(pi) (p(o1e^2+o2e^2)/2 - o1e o2e)/c H2

    K evaluations of ``gd`` instead of K^2 of ``f`` — and identical
    downstream :func:`finalize` semantics.
    """
    dtype = u1.dtype
    o1e = o1 * _SQRT2
    o2e = o2 * _SQRT2
    delta = u1 - u2
    c = o1e * o1e + o2e * o2e - 2.0 * p * o1e * o2e
    c = jnp.maximum(c, jnp.asarray(jnp.finfo(dtype).tiny, dtype))
    rc = jnp.sqrt(c)

    site_shape = jnp.broadcast_shapes(u1.shape, u2.shape, o1.shape, o2.shape, p.shape)
    zeros = jnp.zeros(site_shape, dtype)
    tabj = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype).reshape((a.shape[0],) + cshape_tail(site_shape, a.shape[1])),
        tab,
    )

    def body(carry, tc):
        h0, h1, h2 = carry
        x, w = tc
        gv = w * gd(delta + rc * x)
        return (
            h0 + jnp.sum(gv, 0),
            h1 + jnp.sum(gv * x, 0),
            h2 + jnp.sum(gv * (x * x - 0.5), 0),
        ), None

    (H0, H1, H2), _ = jax.lax.scan(body, (zeros, zeros, zeros), tabj, unroll=unroll)

    sq_pi = jnp.asarray(math.sqrt(math.pi), dtype)
    h1s = sq_pi * H1 / rc
    h2s = sq_pi * H2 / c
    sq = o1e * o1e - o2e * o2e
    return GQRaw(
        Ei=sq_pi * H0,
        Z1=(o1e - p * o2e) * h1s,
        Z2=(p * o1e - o2e) * h1s,
        Sa=sq_pi * H2,
        Sm=sq * jnp.sqrt(1.0 - p * p) * h2s,
        Sxy=(0.5 * p * (o1e * o1e + o2e * o2e) - o1e * o2e) * h2s,
    )


def finalize(
    raw: GQRaw,
    a: jnp.ndarray,
    o1: jnp.ndarray,
    o2: jnp.ndarray,
    p: jnp.ndarray,
    T,
    entropy_scale: float,
) -> GQGrads:
    """Apply the per-site scale factors and temperature (entropy) terms.

    ``entropy_scale`` is :data:`NODE` (+3) or :data:`EDGE` (-1); with
    ``cn = entropy_scale * T`` this reproduces ``gqmap_gpu_mixture.m:107-115``
    (node) and ``:137-145`` (edge) for both signs at once.
    """
    dtype = raw.Ei.dtype
    inv_pi = jnp.asarray(1.0 / math.pi, dtype)
    cn = jnp.asarray(entropy_scale, dtype) * jnp.asarray(T, dtype)
    pr = 1.0 - p * p
    sqrtpr = jnp.sqrt(pr)

    du1 = a * (raw.Z1 - p * raw.Z2) * (_SQRT2 / (o1 * pr)) * inv_pi
    du2 = a * (raw.Z2 - p * raw.Z1) * (_SQRT2 / (o2 * pr)) * inv_pi
    da = raw.Ei * inv_pi - cn * (_CONST1 + jnp.log(sqrtpr * o1 * o2))
    sm_w = raw.Sm / sqrtpr
    do1 = a * ((raw.Sa + sm_w) * inv_pi - cn) / o1
    do2 = a * ((raw.Sa - sm_w) * inv_pi - cn) / o2
    dp = a * ((2.0 * raw.Sxy - p * raw.Sa) * inv_pi + cn * p) / pr
    E = a * da
    return GQGrads(da=da, du1=du1, du2=du2, do1=do1, do2=do2, dp=dp, E=E)


def finalize_closed(
    Ef, dEdu1, dEdu2, dEdo1, dEdo2, dEdp,
    a, o1, o2, p, T, entropy_scale: float,
) -> GQGrads:
    """:func:`finalize` for estimators that produce *exact derivatives of the
    expected potential* directly (e.g. the closed-form cosine data term)
    instead of raw quadrature sums.

    The Stein-identity outputs of :func:`finalize` are precisely
    ``a * dE/dtheta`` plus the temperature (Bethe-entropy) terms; this
    applies the same alpha weighting and entropy corrections to closed-form
    ``dE/dtheta`` inputs, keeping one semantics for both paths
    (``gqmap_gpu_mixture.m:107-115`` / ``:137-145``).
    """
    dtype = Ef.dtype
    cn = jnp.asarray(entropy_scale, dtype) * jnp.asarray(T, dtype)
    pr = 1.0 - p * p
    da = Ef - cn * (_CONST1 + jnp.log(jnp.sqrt(pr) * o1 * o2))
    du1 = a * dEdu1
    du2 = a * dEdu2
    do1 = a * (dEdo1 - cn / o1)
    do2 = a * (dEdo2 - cn / o2)
    dp = a * (dEdp + cn * p / pr)
    return GQGrads(da=da, du1=du1, du2=du2, do1=do1, do2=do2, dp=dp, E=a * da)


def gq_ei(
    f, u1, u2, o1, o2, p, tab: QuadTable, *, unroll: int = 1
) -> jnp.ndarray:
    """Ei only (sum of weighted potential values) — the lean path for the
    autodiff gradient estimator, where derivatives come from jax.grad of
    the expectation rather than the Stein identities."""
    dtype = u1.dtype
    s = (jnp.sqrt(1.0 + p) + jnp.sqrt(1.0 - p)) * 0.5
    t = (jnp.sqrt(1.0 + p) - jnp.sqrt(1.0 - p)) * 0.5
    o1e = o1 * _SQRT2
    o2e = o2 * _SQRT2
    site_shape = jnp.broadcast_shapes(u1.shape, u2.shape, o1.shape, o2.shape, p.shape)
    tabj = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype).reshape((a.shape[0],) + cshape_tail(site_shape, a.shape[1])),
        tab,
    )

    def body(carry, tc):
        xi, xj, wiwj, *_ = tc
        zi = s * xi + t * xj
        zj = t * xi + s * xj
        fv = wiwj * f(o1e * zi + u1, o2e * zj + u2)
        return carry + jnp.sum(fv, 0), None

    out, _ = jax.lax.scan(body, jnp.zeros(site_shape, dtype), tabj, unroll=unroll)
    return out


class GQChainRaw(NamedTuple):
    """Raw sums for the chain-rule (image-gradient) estimator."""

    Ei: jnp.ndarray   # sum w * f
    A1: jnp.ndarray   # sum w * df/dx1
    A2: jnp.ndarray   # sum w * df/dx2
    Ci: jnp.ndarray   # sum w * df/dx1 * XI
    Cj: jnp.ndarray   # sum w * df/dx1 * XJ
    Di: jnp.ndarray   # sum w * df/dx2 * XI
    Dj: jnp.ndarray   # sum w * df/dx2 * XJ


def gq_accumulate_chain(
    fg: Callable,
    u1, u2, o1, o2, p,
    tab: QuadTable,
    *,
    unroll: int = 1,
) -> GQChainRaw:
    """Accumulate the chain-rule estimator sums over every site.

    ``fg(x1, x2) -> (f, df/dx1, df/dx2)`` supplies the potential value AND
    its analytic spatial derivatives (e.g. from precomputed image-gradient
    fields). This is the alternative gradient-estimator family of
    ``legacy/gqmap_gpuV3.m:91-125``: parameter gradients by quadrature of
    ``df/dx`` (different quadrature-noise characteristics than the Stein
    identities — the derivative of the integrand is sampled, not the
    integrand times a polynomial).
    """
    dtype = u1.dtype
    s = (jnp.sqrt(1.0 + p) + jnp.sqrt(1.0 - p)) * 0.5
    t = (jnp.sqrt(1.0 + p) - jnp.sqrt(1.0 - p)) * 0.5
    o1e = o1 * _SQRT2
    o2e = o2 * _SQRT2

    site_shape = jnp.broadcast_shapes(u1.shape, u2.shape, o1.shape, o2.shape, p.shape)
    zeros = jnp.zeros(site_shape, dtype)
    init = GQChainRaw(zeros, zeros, zeros, zeros, zeros, zeros, zeros)
    tabj = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype).reshape((a.shape[0],) + cshape_tail(site_shape, a.shape[1])),
        tab,
    )

    def body(carry: GQChainRaw, tc) -> tuple[GQChainRaw, None]:
        xi, xj, wiwj, *_ = tc
        zi = s * xi + t * xj
        zj = t * xi + s * xj
        f, g1, g2 = fg(o1e * zi + u1, o2e * zj + u2)
        w1 = wiwj * g1
        w2 = wiwj * g2
        new = GQChainRaw(
            Ei=carry.Ei + jnp.sum(wiwj * f, 0),
            A1=carry.A1 + jnp.sum(w1, 0),
            A2=carry.A2 + jnp.sum(w2, 0),
            Ci=carry.Ci + jnp.sum(w1 * xi, 0),
            Cj=carry.Cj + jnp.sum(w1 * xj, 0),
            Di=carry.Di + jnp.sum(w2 * xi, 0),
            Dj=carry.Dj + jnp.sum(w2 * xj, 0),
        )
        return new, None

    raw, _ = jax.lax.scan(body, init, tabj, unroll=unroll)
    return raw


def finalize_chain(
    raw: GQChainRaw,
    a, o1, o2, p, T,
    entropy_scale: float,
) -> GQGrads:
    """Chain-rule sums -> finalized gradients.

    With ``x1 = sqrt2 o1 (s XI + t XJ) + u1`` (and symmetrically x2),

        dE/du1 = E[df/dx1]
        dE/do1 = sqrt2 E[df/dx1 (s XI + t XJ)]
        dE/dp  = sqrt2 ( o1 E[df/dx1 (ds XI + dt XJ)]
                       + o2 E[df/dx2 (dt XI + ds XJ)] ),
        ds = (1/sqrt(1+p) - 1/sqrt(1-p))/4,   dt = (1/sqrt(1+p) + 1/sqrt(1-p))/4

    (the spectral-transform derivative of ``legacy/gqmap_gpuV3.m:95-114``),
    then the shared alpha/Bethe-entropy finalization of
    :func:`finalize_closed`.
    """
    dtype = raw.Ei.dtype
    inv_pi = jnp.asarray(1.0 / math.pi, dtype)
    q = jnp.sqrt(1.0 + p)
    r = jnp.sqrt(1.0 - p)
    s = (q + r) * 0.5
    t = (q - r) * 0.5
    ds = (1.0 / q - 1.0 / r) * 0.25
    dt = (1.0 / q + 1.0 / r) * 0.25
    Ef = raw.Ei * inv_pi
    dEdu1 = raw.A1 * inv_pi
    dEdu2 = raw.A2 * inv_pi
    dEdo1 = _SQRT2 * (s * raw.Ci + t * raw.Cj) * inv_pi
    dEdo2 = _SQRT2 * (t * raw.Di + s * raw.Dj) * inv_pi
    dEdp = _SQRT2 * (
        o1 * (ds * raw.Ci + dt * raw.Cj) + o2 * (dt * raw.Di + ds * raw.Dj)
    ) * inv_pi
    return finalize_closed(Ef, dEdu1, dEdu2, dEdo1, dEdo2, dEdp, a, o1, o2, p, T, entropy_scale)


def gq_ei_diff(
    gd, u1, u2, o1, o2, p, tab: QuadTable1D, *, unroll: int = 1
) -> jnp.ndarray:
    """Ei via the 1-D difference-reduced rule: ``sqrt(pi) * sum_k w_k gd(d_k)``.

    Companion of :func:`gq_accumulate_diff` for the autodiff gradient
    estimator — the expectation of a pure difference potential
    ``f(x1, x2) = gd(x1 - x2)`` only needs the 1-D marginal
    ``d ~ N(u1 - u2, o1e^2 + o2e^2 - 2 p o1e o2e)``. Fully differentiable
    w.r.t. all five parameters (``jax.grad`` flows through ``delta`` and the
    variance), so ``edge_quad="reduced"`` composes with
    ``gradient_estimator="autodiff"``.
    """
    dtype = u1.dtype
    o1e = o1 * _SQRT2
    o2e = o2 * _SQRT2
    delta = u1 - u2
    c = o1e * o1e + o2e * o2e - 2.0 * p * o1e * o2e
    c = jnp.maximum(c, jnp.asarray(jnp.finfo(dtype).tiny, dtype))
    rc = jnp.sqrt(c)

    site_shape = jnp.broadcast_shapes(u1.shape, u2.shape, o1.shape, o2.shape, p.shape)
    tabj = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype).reshape((a.shape[0],) + cshape_tail(site_shape, a.shape[1])),
        tab,
    )

    def body(carry, tc):
        x, w = tc
        return carry + jnp.sum(w * gd(delta + rc * x), 0), None

    h0, _ = jax.lax.scan(body, jnp.zeros(site_shape, dtype), tabj, unroll=unroll)
    return jnp.asarray(math.sqrt(math.pi), dtype) * h0


def gq_expectation(
    f: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    u1, u2, o1, o2, p,
    tab: QuadTable,
) -> jnp.ndarray:
    """Plain quadrature estimate of ``E_q[f]`` (no gradients): ``Ei / pi``.

    Useful for testing the Stein-identity gradients against ``jax.grad`` of
    this expectation (exact agreement for polynomial ``f`` of degree
    <= 2K-1).
    """
    raw = gq_accumulate(f, u1, u2, o1, o2, p, tab)
    return raw.Ei / math.pi
