"""Closed-form cosine-spectral data term: zero quadrature, exact gradients.

The chebyshev data term (:mod:`gqmap_tpu.ops.chebyshev`) removed the
gathers from the reference's bicubic data term (``gqmap_gpu_mixture.m:
156-179``) but still evaluates a degree-(P,Q) polynomial at each of the
K^2 Gauss-Hermite points. This module removes the quadrature loop as well:
expand the per-pixel displacement-cost surface in a tensor-product COSINE
basis (type-II DCT of midpoint samples = mirror-periodized Fourier series,
O(1/w^2) coefficient decay), because the expectation of a cosine mode
under a correlated bivariate Gaussian is the Gaussian characteristic
function — closed form:

    E[cos(a*th1(x1)) cos(b*th2(x2))]
      = 1/2 [ cos(a*ph1 - b*ph2) W-  +  cos(a*ph1 + b*ph2) W+ ],
    W∓ = exp(-(a*s1 - b*s2)^2/2 - a*b*s1*s2*(1 ∓ p))          (both args <= 0)

with ``th_u(x) = pi (x - lo_u)/L_u``, ``ph1 = th_u(u1)``, ``s1 = pi o1/L_u``
(and likewise for v). Every mode is evaluated ONCE per site instead of once
per quadrature point, and all five parameter gradients are *exact
derivatives* of the truncated expectation (no Stein-identity quadrature):

    dE/du1 = -ku/2 sum c a (W-*S- + W+*S+)         S∓ = sin(a ph1 ∓ b ph2)
    dE/du2 = +kv/2 sum c b (W-*S- - W+*S+)
    dE/do1 =  ku/2 (-s1 sum c a^2 (W-C- + W+C+) + s2 p sum c ab (W-C- - W+C+))
    dE/do2 =  kv/2 (-s2 sum c b^2 (W-C- + W+C+) + s1 p sum c ab (W-C- - W+C+))
    dE/dp  =  s1 s2 / 2 sum c ab (W-C- - W+C+)

The W∓ exponents are computed in the algebraically stable split
``-(as1 - bs2)^2/2 - ab s1 s2 (1 ∓ p)`` (a sum of two nonpositive terms —
the naive ``-(a^2 s1^2 + b^2 s2^2)/2 ± ab s1 s2 p`` catastrophically
cancels and can overflow intermediate factors at the sigma clamp maximum).

Trig factors come from rotation recurrences (cos/sin of a*ph1 carried over
the u-degree scan; the small v-degree loop unrolled), so there is exactly
ONE pair of transcendental ``exp`` calls per mode and no ``sin``/``cos``
calls inside the loop at all.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .gq import GQGrads, finalize_closed
from .interp import sample_bicubic

__all__ = ["CosData", "build_cos_data", "cos_node_grads", "cos_ei"]


class CosData(NamedTuple):
    coeffs: jnp.ndarray  # (A, B, M, N) cosine coefficients of npot
    lo_u: jnp.ndarray    # box bounds (scalars)
    hi_u: jnp.ndarray
    lo_v: jnp.ndarray
    hi_v: jnp.ndarray


def _eval_sample_grid(eval_node, uv_grid: np.ndarray, dtype, batch: int = 16):
    """Evaluate the node potential at every displacement sample in one
    device program, ``batch`` full-frame samples at a time (bounds the
    working memory)."""
    return jax.lax.map(eval_node, jnp.asarray(uv_grid, dtype), batch_size=batch)


def _dct2_matrix(P: int) -> np.ndarray:
    """(P, P) type-II DCT matrix D with coeffs = D @ values-at-midpoints,
    normalized so that ``f(x_j) = sum_a c_a cos(a*pi*(j+1/2)/P)``."""
    k = np.arange(P)
    a = np.arange(P)[:, None]
    D = np.cos(np.pi * a * (k + 0.5) / P) * (2.0 / P)
    D[0] *= 0.5
    return D


def _box_mean(npt: jnp.ndarray, rg: int) -> jnp.ndarray:
    """Overlapping-window mean of a per-pixel cost field (edge-padded).

    Because the spectral builds sample at GLOBAL constant displacements,
    the windowed data cost of ``legacy/gqmap_cpuV2.m:29-33`` (mean over the
    (2rg+1)^2 window, displacement shared across it) is exactly a box
    filter of the sampled surface — the window costs nothing at sweep time.
    """
    k = 2 * rg + 1
    p = jnp.pad(npt, rg, mode="edge")
    acc = jnp.zeros_like(npt)
    for di in range(k):
        for dj in range(k):
            acc = acc + jax.lax.slice(p, (di, dj), (di + npt.shape[0], dj + npt.shape[1]))
    return acc / (k * k)


def build_cos_data(
    I1: jnp.ndarray,
    VV: jnp.ndarray,
    lambdad: float,
    epsn: float,
    box: tuple[float, float, float, float],
    A: int = 96,
    B: int = 16,
    patch: int = 1,
    window_rg: int = 0,
    pack: bool = False,
) -> CosData:
    """Precompute the per-pixel cosine coefficient field (one-time, per run).

    Samples the node potential at the (A, B) midpoint grid over the
    displacement box — each sample is a constant-offset bicubic read of
    frame 2, a dense field op with no gathers (same trick as the chebyshev
    build) — then takes a type-II DCT along both displacement axes.
    For ``patch > 1`` the expansion is of the patch-summed potential on the
    flow lattice (``gqmap_gpuSuper_mix_entropy.m:94-105``); for
    ``window_rg > 0`` of the window-MEANED potential (:func:`_box_mean`).
    """
    Mo, No = I1.shape
    M, N = Mo // patch, No // patch
    dtype = I1.dtype
    lo_u, hi_u, lo_v, hi_v = box
    # midpoint sample positions: x_j = lo + (j + 1/2) L / P
    us = lo_u + (np.arange(A) + 0.5) * (hi_u - lo_u) / A
    vs = lo_v + (np.arange(B) + 0.5) * (hi_v - lo_v) / B

    jj = 1.0 + jax.lax.broadcasted_iota(dtype, (1, No), 1)
    ii = 1.0 + jax.lax.broadcasted_iota(dtype, (Mo, 1), 0)
    lam = jnp.asarray(lambdad, dtype)
    eps = jnp.asarray(epsn, dtype)

    def eval_node(uv):
        u, v = uv
        Vq = sample_bicubic(VV, jj + u, ii + v, pack_pairs=pack)
        npt = -lam * jnp.sqrt(eps + (I1 - Vq) ** 2)
        if window_rg > 0:
            npt = _box_mean(npt, window_rg)
        if patch > 1:
            npt = npt.reshape(M, patch, N, patch).sum(axis=(1, 3))
        return npt

    uv_grid = np.stack(np.broadcast_arrays(us[:, None], vs[None, :]), -1).reshape(-1, 2)
    vals = _eval_sample_grid(eval_node, uv_grid, dtype)
    vals = vals.reshape(A, B, M, N)

    Du = jnp.asarray(_dct2_matrix(A), dtype)
    Dv = jnp.asarray(_dct2_matrix(B), dtype)
    # HIGHEST: a GPU may otherwise run an f32 contraction in TF32 (~3 digits).
    coeffs = jnp.einsum("ap,bq,pqmn->abmn", Du, Dv, vals,
                        precision=jax.lax.Precision.HIGHEST)
    return CosData(
        coeffs=coeffs,
        lo_u=jnp.asarray(lo_u, dtype), hi_u=jnp.asarray(hi_u, dtype),
        lo_v=jnp.asarray(lo_v, dtype), hi_v=jnp.asarray(hi_v, dtype),
    )


def _mode_sums(cos: CosData, u1, u2, o1, o2, p, a_block: int, want_grads: bool):
    """Scan the (A, B) mode lattice once; return the accumulated sums.

    Sums (all including the coefficient field):
      E0 = sum c (W-C- + W+C+)          A1 = sum c a (W-S- + W+S+)
      A2 = sum c b (W-S- - W+S+)        Aa = sum c a^2 (W-C- + W+C+)
      Ab = sum c b^2 (W-C- + W+C+)      Ax = sum c ab (W-C- - W+C+)
    """
    coeffs = cos.coeffs
    A, B = coeffs.shape[:2]
    dtype = u1.dtype

    ku = jnp.asarray(math.pi, dtype) / (cos.hi_u - cos.lo_u)
    kv = jnp.asarray(math.pi, dtype) / (cos.hi_v - cos.lo_v)
    ph1 = ku * (u1 - cos.lo_u)
    ph2 = kv * (u2 - cos.lo_v)
    s1 = ku * o1
    s2 = kv * o2
    gm = s1 * s2 * (1.0 - p)   # >= 0
    gp = s1 * s2 * (1.0 + p)   # >= 0
    c1, sn1 = jnp.cos(ph1), jnp.sin(ph1)
    c2, sn2 = jnp.cos(ph2), jnp.sin(ph2)

    site = jnp.broadcast_shapes(u1.shape, u2.shape, o1.shape, o2.shape, p.shape)
    zeros = jnp.zeros(site, dtype)
    ones = jnp.ones(site, dtype)

    nblocks = (A + a_block - 1) // a_block
    Apad = nblocks * a_block
    cpad = jnp.pad(coeffs, ((0, Apad - A), (0, 0), (0, 0), (0, 0)))
    cblocks = cpad.reshape(nblocks, a_block, B, *coeffs.shape[2:])

    n_sums = 6 if want_grads else 1

    def body(carry, cblk):
        ca, sa, a0, sums = carry
        for j in range(a_block):
            a = a0 + j  # traced scalar (int32)
            af = a.astype(dtype)
            as1 = af * s1
            agm = af * gm
            agp = af * gp
            cb, sb = ones, zeros  # cos/sin(b*ph2) at b = 0
            for b in range(B):
                bf = jnp.asarray(float(b), dtype)
                m = as1 - bf * s2
                h = -0.5 * (m * m)
                Wm = jnp.exp(h - bf * agm)
                Wp = jnp.exp(h - bf * agp)
                cacb = ca * cb
                sasb = sa * sb
                U = Wm * (cacb + sasb)   # W- C-
                V = Wp * (cacb - sasb)   # W+ C+
                cab = cblk[j, b]
                if want_grads:
                    sacb = sa * cb
                    casb = ca * sb
                    Pt = Wm * (sacb - casb)  # W- S-
                    Qt = Wp * (sacb + casb)  # W+ S+
                    E0, A1, A2, Aa, Ab, Ax = sums
                    UV = cab * (U + V)
                    sums = (
                        E0 + UV,
                        A1 + (af * cab) * (Pt + Qt),
                        A2 + (bf * cab) * (Pt - Qt),
                        Aa + (af * af) * UV,
                        Ab + (bf * bf) * UV,
                        Ax + (af * bf * cab) * (U - V),
                    )
                else:
                    (E0,) = sums
                    sums = (E0 + cab * (U + V),)
                cb, sb = cb * c2 - sb * sn2, sb * c2 + cb * sn2
            ca, sa = ca * c1 - sa * sn1, sa * c1 + ca * sn1
        return (ca, sa, a0 + a_block, sums), None

    init = (ones, zeros, jnp.asarray(0, jnp.int32), (zeros,) * n_sums)
    (_, _, _, sums), _ = jax.lax.scan(body, init, cblocks)
    return sums, (ku, kv, s1, s2)


def cos_ei(cos: CosData, u1, u2, o1, o2, p, a_block: int = 8) -> jnp.ndarray:
    """Closed-form E[npot] under the correlated bivariate Gaussian (exact
    expectation of the truncated cosine surface). Differentiable — usable
    directly by the autodiff gradient-estimator path."""
    (E0,), _ = _mode_sums(cos, u1, u2, o1, o2, p, a_block, want_grads=False)
    return 0.5 * E0


def _finalize_mode_sums(
    cos: CosData, sums, u1, o1, o2, p, a, T, entropy_scale: float
) -> GQGrads:
    """Turn the six mode sums into finalized gradients (shared by the XLA
    path and the GPU kernel, :mod:`gqmap_tpu.kernels.cosine_gq`)."""
    E0, A1, A2, Aa, Ab, Ax = sums
    dtype = E0.dtype
    ku = jnp.asarray(math.pi, dtype) / (cos.hi_u - cos.lo_u)
    kv = jnp.asarray(math.pi, dtype) / (cos.hi_v - cos.lo_v)
    s1 = ku * o1
    s2 = kv * o2
    Ef = 0.5 * E0
    dEdu1 = -0.5 * ku * A1
    dEdu2 = 0.5 * kv * A2
    dEdo1 = 0.5 * ku * (s2 * p * Ax - s1 * Aa)
    dEdo2 = 0.5 * kv * (s1 * p * Ax - s2 * Ab)
    dEdp = 0.5 * s1 * s2 * Ax
    return finalize_closed(Ef, dEdu1, dEdu2, dEdo1, dEdo2, dEdp, a, o1, o2, p, T, entropy_scale)


def cos_node_grads(
    cos: CosData, u1, u2, o1, o2, p, a, T, entropy_scale: float,
    a_block: int = 8,
) -> GQGrads:
    """Expected node potential and its five exact parameter gradients,
    finalized with the alpha weighting and Bethe-entropy terms exactly like
    the quadrature path (:func:`gqmap_tpu.ops.gq.finalize`)."""
    sums, _ = _mode_sums(cos, u1, u2, o1, o2, p, a_block, want_grads=True)
    return _finalize_mode_sums(cos, sums, u1, o1, o2, p, a, T, entropy_scale)
