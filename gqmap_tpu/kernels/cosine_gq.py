"""Pallas GPU kernel (Triton route): fused cosine-spectral node term.

XLA compiles :func:`gqmap_tpu.ops.cosine._mode_sums` into a scan over
u-degree blocks whose unrolled (a, b) body carries six lattice-sized
accumulators per component through device memory between fusions. This
kernel keeps the whole mode loop of a block of sites in registers: each
program owns ``block`` consecutive sites of the flattened ``(M*N)`` lattice
(the ragged tail is masked, so no lattice width costs padding), carries all
L mixture components, streams the ``(A, B, M*N)`` coefficient field once
(each coefficient is loaded once and used for all L components), and
writes the six mode sums once.

* The u-degree axis is a loop inside the program, not a grid axis: blocks
  run in parallel and in no order, so nothing accumulates across programs.
* The v-degree loop (B, small and static) is fully unrolled.
* Adaptive u-cutoff: a block-wide reduction bounds every remaining mode
  weight (:func:`_adaptive_trip`), so wide-sigma blocks stop early.
* Zero-exp recurrence: where a block-wide bound proves no weight can
  underflow and later recover, the inner body replaces the two ``exp`` per
  mode by exact multiplicative recurrences; a ``lax.cond`` picks the body.

Math identical to :mod:`gqmap_tpu.ops.cosine` (characteristic-function
closed form of ``E[cos(a th1(x1)) cos(b th2(x2))]`` with the stable
exponent split); reference semantics per ``gqmap_gpu_mixture.m:87-116``.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["cos_mode_sums_pallas", "cos_node_grads_pallas"]

# Sites per program and warps per program. One site per thread keeps the
# ~25 loop-carried values per component (x L components) in registers; a
# 226k-site Middlebury lattice gives ~900 programs, ~7 per SM. Chosen on an
# H100 among 64/2, 128/4, 256/4 and 256/8 (PERF.md).
BLOCK = 256
NUM_WARPS = 8

# The recurrence is used only while every exponent along its path stays
# below e^79 in magnitude (see _kernel): (a_max s1_max + B s2_max)^2 < 79.
_RECUR_BOUND = 8.9
# Cutoff margin: skipped modes weigh below e^{-theta^2/2} = e^-50.
_THETA = 10.0


def _adaptive_trip(s1_min, s2_max, A: int, B: int):
    """Block-wide u-degree trip count for the adaptive cutoff.

    Every mode weight obeys ``W± <= exp(-0.5 (a s1 - b s2)^2)`` (the cross
    factor ``exp(-a b g±)`` is <= 1 since g± = s1 s2 (1 ∓ p) >= 0), so once
    ``a s1 > (B-1) s2 + theta`` every remaining (a, b) term of the block is
    below ``e^{-theta^2/2}``; theta = 10 leaves a < e^-50 tail, invisible
    even against the a²-weighted gradient sums.
    """
    dtype = s1_min.dtype
    a_cut = ((B - 1.0) * s2_max + _THETA) / jnp.maximum(
        s1_min, jnp.asarray(1e-20, dtype)
    )
    return jnp.clip(jnp.ceil(a_cut).astype(jnp.int32) + 1, 0, A)


def _kernel(sp_ref, c_ref, out_ref, *, A: int, B: int, L: int, S: int,
            block: int):
    dtype = out_ref.dtype
    idx = pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)
    valid = idx < S
    zeros = jnp.zeros((block,), dtype)
    ones = jnp.ones((block,), dtype)

    def load(ref, *lead):
        return plgpu.load(ref.at[(*lead, idx)], mask=valid, other=0.0)

    # Phases and scales arrive precomputed (ph = k (mu - lo), s = k sigma);
    # masked tail sites read zero scale and zero coefficients, which keeps
    # them inert, and the block statistics below exclude them.
    ph1, ph2, s1, s2, p = (
        [load(sp_ref, k, l) for l in range(L)] for k in range(5)
    )
    c1 = [jnp.cos(x) for x in ph1]
    sn1 = [jnp.sin(x) for x in ph1]
    c2 = [jnp.cos(x) for x in ph2]
    sn2 = [jnp.sin(x) for x in ph2]

    inf = jnp.asarray(jnp.inf, dtype)
    s1_min = functools.reduce(
        jnp.minimum, [jnp.min(jnp.where(valid, x, inf)) for x in s1])
    s1_max = functools.reduce(jnp.maximum, [jnp.max(x) for x in s1])
    s2_max = functools.reduce(jnp.maximum, [jnp.max(x) for x in s2])
    trip = _adaptive_trip(s1_min, s2_max, A, B)

    def coeffs(a):
        return [load(c_ref, a, b) for b in range(B)]

    def outer(carry, l, af, sE, sEb, sP, sPm, sXb):
        """Fold one u-degree's v-sums into component l's carries."""
        ca, sa, E0, A1, A2, Aa, Ab, Ax = carry[l]
        return (
            ca * c1[l] - sa * sn1[l],
            sa * c1[l] + ca * sn1[l],
            E0 + sE,
            A1 + af * sP,
            A2 + sPm,
            Aa + (af * af) * sE,
            Ab + sEb,
            Ax + af * sXb,
        )

    gm = [s1[l] * s2[l] * (1.0 - p[l]) for l in range(L)]
    gp = [s1[l] * s2[l] * (1.0 + p[l]) for l in range(L)]

    def exp_body(a, carry):
        af = a.astype(dtype)
        cab = coeffs(a)
        new = []
        for l in range(L):
            ca, sa = carry[l][:2]
            agm = af * gm[l]
            agp = af * gp[l]
            m = af * s1[l]
            cb, sb = ones, zeros
            sE = sEb = sP = sPm = sXb = zeros
            for b in range(B):
                bf = float(b)
                h = -0.5 * (m * m)
                Wm = jnp.exp(h - bf * agm)
                Wp = jnp.exp(h - bf * agp)
                cWm = cab[b] * Wm
                cWp = cab[b] * Wp
                t1 = ca * cb
                t2 = sa * sb
                t3 = sa * cb
                t4 = ca * sb
                cU = cWm * (t1 + t2)
                cV = cWp * (t1 - t2)
                cP = cWm * (t3 - t4)
                cQ = cWp * (t3 + t4)
                uv = cU + cV
                sE = sE + uv
                sEb = sEb + (bf * bf) * uv
                sP = sP + (cP + cQ)
                sPm = sPm + bf * (cP - cQ)
                sXb = sXb + bf * (cU - cV)
                m = m - s2[l]
                cb, sb = cb * c2[l] - sb * sn2[l], sb * c2[l] + cb * sn2[l]
            new.append(outer(carry, l, af, sE, sEb, sP, sPm, sXb))
        return tuple(new)

    # Zero-exp body: Wm(b) and Wp(b) evolve by the exact recurrences
    #   Wm(b+1) = Wm(b) fm(b),  fm(b+1) = fm(b) r,
    #   fm(0) = exp(a s1 s2 p - s2^2/2),  r = exp(-s2^2)
    # (fp with the sign of p flipped), from
    #   h(b+1) - h(b) - a gm = a s1 s2 p - s2^2 (b + 1/2).
    # Three exps per (a, site, component) instead of two per mode. Valid
    # only where no intermediate weight underflows and later recovers
    # (Wm(0) = exp(-(a s1)^2/2) dies at a s1 > ~13 while Wm(b ~ a s1/s2)
    # can be O(1): the wide-sigma correlated case the stable exponent
    # split exists for). Every exponent along the path is bounded by
    # (a_max s1_max + B s2_max)^2, so the body is taken only when that is
    # below _RECUR_BOUND^2 ~ 79 for the whole block — the tight-sigma
    # converged regime.
    spp = [s1[l] * s2[l] * p[l] for l in range(L)]
    hs2 = [0.5 * (s2[l] * s2[l]) for l in range(L)]
    rr = [jnp.exp(-(s2[l] * s2[l])) for l in range(L)]

    def recur_body(a, carry):
        af = a.astype(dtype)
        cab = coeffs(a)
        new = []
        for l in range(L):
            ca, sa = carry[l][:2]
            as1 = af * s1[l]
            wm = jnp.exp(-0.5 * (as1 * as1))
            wp = wm
            arg = af * spp[l]
            fm = jnp.exp(arg - hs2[l])
            fp = jnp.exp(-arg - hs2[l])
            cb, sb = ones, zeros
            sE = sEb = sP = sPm = sXb = zeros
            for b in range(B):
                bf = float(b)
                apl = cab[b] * (wm + wp)
                ami = cab[b] * (wm - wp)
                t1 = ca * cb
                t2 = sa * sb
                t3 = sa * cb
                t4 = ca * sb
                Et = t1 * apl + t2 * ami   # c (U + V)
                Xt = t1 * ami + t2 * apl   # c (U - V)
                Pt = t3 * apl - t4 * ami   # c (P + Q)
                Mt = t3 * ami - t4 * apl   # c (P - Q)
                sE = sE + Et
                sEb = sEb + (bf * bf) * Et
                sP = sP + Pt
                sPm = sPm + bf * Mt
                sXb = sXb + bf * Xt
                wm = wm * fm
                fm = fm * rr[l]
                wp = wp * fp
                fp = fp * rr[l]
                cb, sb = cb * c2[l] - sb * sn2[l], sb * c2[l] + cb * sn2[l]
            new.append(outer(carry, l, af, sE, sEb, sP, sPm, sXb))
        return tuple(new)

    init = tuple((ones,) + (zeros,) * 7 for _ in range(L))
    safe = trip.astype(dtype) * s1_max + B * s2_max < _RECUR_BOUND
    out = jax.lax.cond(
        safe,
        lambda: jax.lax.fori_loop(0, trip, recur_body, init),
        lambda: jax.lax.fori_loop(0, trip, exp_body, init),
    )
    for l in range(L):
        for k, v in enumerate(out[l][2:]):
            plgpu.store(out_ref.at[k, l, idx], v, mask=valid)


def cos_mode_sums_pallas(
    cos, u1, u2, o1, o2, p, *, block: int = BLOCK, num_warps: int = NUM_WARPS,
    interpret: bool = False,
):
    """Six cosine mode sums over ``(L, M, N)`` state (see ops/cosine.py).

    Grid: one program per ``block`` sites of the flattened lattice.
    ``interpret=True`` runs the kernel on the CPU (tests only).
    """
    coeffs = cos.coeffs
    A, B = coeffs.shape[:2]
    L, M, N = jnp.broadcast_shapes(
        u1.shape, u2.shape, o1.shape, o2.shape, p.shape)
    S = M * N
    dtype = u1.dtype
    if block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")

    ku = jnp.asarray(math.pi, dtype) / (cos.hi_u - cos.lo_u)
    kv = jnp.asarray(math.pi, dtype) / (cos.hi_v - cos.lo_v)
    sp = jnp.stack([
        jnp.broadcast_to(x, (L, M, N)).reshape(L, S)
        for x in (ku * (u1 - cos.lo_u), kv * (u2 - cos.lo_v),
                  ku * o1, kv * o2, p)
    ])
    fn = pl.pallas_call(
        functools.partial(_kernel, A=A, B=B, L=L, S=S, block=block),
        grid=(pl.cdiv(S, block),),
        out_shape=jax.ShapeDtypeStruct((6, L, S), dtype),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps),
        backend="triton",
        interpret=interpret,
        name="cos_mode_sums",
    )
    outs = fn(sp, coeffs.reshape(A, B, S))
    return tuple(outs[k].reshape(L, M, N) for k in range(6))


def cos_node_grads_pallas(
    cos, u1, u2, o1, o2, p, a, T, entropy_scale: float, *,
    block: int = BLOCK, num_warps: int = NUM_WARPS, interpret: bool = False,
):
    """Drop-in kernel replacement for :func:`gqmap_tpu.ops.cosine.cos_node_grads`."""
    from ..ops.cosine import _finalize_mode_sums

    sums = cos_mode_sums_pallas(
        cos, u1, u2, o1, o2, p, block=block, num_warps=num_warps,
        interpret=interpret,
    )
    return _finalize_mode_sums(cos, sums, u1, o1, o2, p, a, T, entropy_scale)
