"""Gather-free spectral (Chebyshev) data term.

The reference's per-sample 16-tap bicubic data term is gather-bound
(~660M taps/sweep at Middlebury scale). This module replaces the
per-sample *lookup* with per-sample *dense compute*:

1. Per pixel, the displacement-cost surface
   ``npot(u, v) = -lambda_d sqrt(eps + (I1(i,j) - I2^b(i+v, j+u))^2)``
   is expanded in a tensor-product Chebyshev basis over a displacement box
   (the mu clamp range + margin). The expansion nodes are GLOBAL
   displacements, so each node evaluation is a constant-offset bicubic
   sample of frame 2 — a dense field operation, no gathers. Coefficients
   come from a type-II DCT (two small matmuls on the MXU).
2. Per sweep, the quadrature samples evaluate the polynomial by Chebyshev
   recurrence + contraction against the per-pixel coefficient field —
   O(P*Q) fused multiply-adds per sample, zero gathers.

Approximation knobs: box margin (samples beyond the box clamp to its edge,
mirroring the reference's image-boundary position clamp) and the degrees
(P, Q). This is an additional operating mode; the exact
gather-based bicubic/nearest terms remain available.
"""

from __future__ import annotations


from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .interp import sample_bicubic

__all__ = ["ChebData", "build_cheb_data", "make_node_pot_chebyshev"]


class ChebData(NamedTuple):
    coeffs: jnp.ndarray  # (P, Q, M, N) Chebyshev coefficients of npot
    lo_u: jnp.ndarray    # box bounds (scalars)
    hi_u: jnp.ndarray
    lo_v: jnp.ndarray
    hi_v: jnp.ndarray


def _cheb_nodes(P: int) -> np.ndarray:
    """First-kind Chebyshev nodes on [-1, 1], k = 0..P-1."""
    return np.cos(np.pi * (np.arange(P) + 0.5) / P)


def _dct_matrix(P: int) -> np.ndarray:
    """(P, P) matrix D with coeffs = D @ values-at-nodes."""
    k = np.arange(P)
    a = np.arange(P)[:, None]
    D = np.cos(np.pi * a * (k + 0.5) / P) * (2.0 / P)
    D[0] *= 0.5
    return D


def build_cheb_data(
    I1: jnp.ndarray,
    VV: jnp.ndarray,
    lambdad: float,
    epsn: float,
    box: tuple[float, float, float, float],
    P: int = 64,
    Q: int = 64,
    patch: int = 1,
    window_rg: int = 0,
    pack: bool = False,
) -> ChebData:
    """Precompute the per-pixel coefficient field (one-time, per run).

    ``box = (lo_u, hi_u, lo_v, hi_v)`` in pixels. For ``patch > 1`` the
    expansion is of the PATCH-SUMMED node potential on the flow lattice
    (``gqmap_gpuSuper_mix_entropy.m:94-105``), so the sweep-time cost is
    independent of the patch size; for ``window_rg > 0`` of the
    window-MEANED potential (``legacy/gqmap_cpuV2.m:29-33`` — a box filter
    of the sampled surface, likewise free at sweep time).
    """
    Mo, No = I1.shape
    M, N = Mo // patch, No // patch
    dtype = I1.dtype
    lo_u, hi_u, lo_v, hi_v = box
    xu = _cheb_nodes(P)
    xv = _cheb_nodes(Q)
    us = (lo_u + hi_u) / 2.0 + (hi_u - lo_u) / 2.0 * xu  # (P,)
    vs = (lo_v + hi_v) / 2.0 + (hi_v - lo_v) / 2.0 * xv  # (Q,)

    jj = 1.0 + jax.lax.broadcasted_iota(dtype, (1, No), 1)
    ii = 1.0 + jax.lax.broadcasted_iota(dtype, (Mo, 1), 0)
    lam = jnp.asarray(lambdad, dtype)
    eps = jnp.asarray(epsn, dtype)

    def eval_node(uv):
        u, v = uv
        # constant displacement: a uniformly shifted (clamped) field sample
        Vq = sample_bicubic(VV, jj + u, ii + v, pack_pairs=pack)
        npt = -lam * jnp.sqrt(eps + (I1 - Vq) ** 2)
        if window_rg > 0:
            from .cosine import _box_mean

            npt = _box_mean(npt, window_rg)
        if patch > 1:
            npt = npt.reshape(M, patch, N, patch).sum(axis=(1, 3))
        return npt

    from .cosine import _eval_sample_grid

    uv_grid = np.stack(np.broadcast_arrays(us[:, None], vs[None, :]), -1).reshape(-1, 2)
    vals = _eval_sample_grid(eval_node, uv_grid, dtype)
    vals = vals.reshape(P, Q, M, N)

    Du = jnp.asarray(_dct_matrix(P), dtype)
    Dv = jnp.asarray(_dct_matrix(Q), dtype)
    # HIGHEST: a GPU may otherwise run an f32 contraction in TF32 (~3 digits).
    coeffs = jnp.einsum("ap,bq,pqmn->abmn", Du, Dv, vals,
                        precision=jax.lax.Precision.HIGHEST)
    return ChebData(
        coeffs=coeffs,
        lo_u=jnp.asarray(lo_u, dtype), hi_u=jnp.asarray(hi_u, dtype),
        lo_v=jnp.asarray(lo_v, dtype), hi_v=jnp.asarray(hi_v, dtype),
    )


def make_node_pot_chebyshev(cheb: ChebData, a_block: int = 8):
    """Return ``f(x1, x2)`` evaluating the spectral data term.

    Inputs have shape ``lead + (M, N)`` (displacement samples); evaluation
    is a Clenshaw-free direct recurrence, scanned over blocks of ``a_block``
    u-degrees to bound carried traffic.
    """
    coeffs = cheb.coeffs
    P, Q = coeffs.shape[:2]

    def f(x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
        dtype = x1.dtype
        cu = (cheb.lo_u + cheb.hi_u) * 0.5
        ru = (cheb.hi_u - cheb.lo_u) * 0.5
        cv = (cheb.lo_v + cheb.hi_v) * 0.5
        rv = (cheb.hi_v - cheb.lo_v) * 0.5
        up = jnp.clip((x1 - cu) / ru, -1.0, 1.0)
        vp = jnp.clip((x2 - cv) / rv, -1.0, 1.0)

        # T_b(v') for all b (Q small): unrolled recurrence
        Tv = [jnp.ones_like(vp), vp]
        for _ in range(2, Q):
            Tv.append(2.0 * vp * Tv[-1] - Tv[-2])
        Tv = Tv[:Q]

        two_up = 2.0 * up

        # inner contraction for one u-degree a: S_a = sum_b C[a, b] * T_b
        def S(a_coeffs):  # (Q, M, N) -> lead + (M, N)
            acc = a_coeffs[0] * Tv[0]
            for b in range(1, Q):
                acc = acc + a_coeffs[b] * Tv[b]
            return acc

        nblocks = (P + a_block - 1) // a_block
        Ppad = nblocks * a_block
        cpad = jnp.pad(coeffs, ((0, Ppad - P), (0, 0), (0, 0), (0, 0)))
        cblocks = cpad.reshape(nblocks, a_block, Q, *coeffs.shape[2:])

        def body(carry, cblk):
            acc, Tm1, Tm2, a0 = carry
            for j in range(a_block):
                # T_a via recurrence; degrees 0/1 handled by the seeds
                Ta = jnp.where(a0 + j == 0, jnp.ones_like(up),
                               jnp.where(a0 + j == 1, up, two_up * Tm1 - Tm2))
                acc = acc + Ta * S(cblk[j])
                Tm2, Tm1 = Tm1, Ta
            return (acc, Tm1, Tm2, a0 + a_block), None

        zeros = jnp.zeros(jnp.broadcast_shapes(up.shape, vp.shape), dtype)
        init = (zeros, zeros, zeros, jnp.asarray(0, jnp.int32))
        (acc, _, _, _), _ = jax.lax.scan(body, init, cblocks)
        return acc

    return f
