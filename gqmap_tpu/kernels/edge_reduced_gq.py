"""Pallas GPU kernel (Triton route): fused reduced-1D edge gradients.

The XLA path for the edge term is the K1-point scan of
:func:`gqmap_tpu.ops.gq.gq_accumulate_diff` followed by the GQRaw transform
and :func:`gqmap_tpu.ops.gq.finalize` over the 12-plane (dir, chan, L, M, N)
edge arrays. This kernel does all of it per block of sites in registers:
one read of the five per-edge inputs, the 1-D quadrature loop unrolled
with its nodes as constants, and one write of the six finalized gradient
fields.

Math identical to ``gq_accumulate_diff`` + ``finalize`` (the exact Gaussian
conditioning of the difference potential; reference edge semantics
``gqmap_gpu_mixture.m:118-146`` with the Bethe edge-entropy term ``+T``,
``:139-145``). Charbonnier edges only (``gqmap_gpu_mixture.m:180-182``).

``finalize`` computes ``Sm / sqrt(1-p^2)`` while the reduced transform
computes ``Sm = (o1e^2-o2e^2) sqrt(1-p^2) h2s``: the ``sqrt(1-p^2)``
factors cancel, so the kernel never forms them for the sigma gradients.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..ops.gq import GQGrads
from ..ops.quadrature import gauss_hermite

__all__ = ["edge_reduced_grads_pallas"]

_SQRT2 = math.sqrt(2.0)
_SQRT_PI = math.sqrt(math.pi)
_INV_PI = 1.0 / math.pi
_CONST1 = 1.0 + math.log(2.0 * math.pi)

# Sites per program and warps per program, chosen on an H100 among 128/4,
# 256/4 and 512/8 (PERF.md).
BLOCK = 512
NUM_WARPS = 8


def _kernel(alpha_ref, t_ref, u1_ref, o1_ref, u2_ref, o2_ref, p_ref,
            da_ref, du1_ref, du2_ref, do1_ref, do2_ref, dp_ref,
            *, nodes, CL: int, L: int, S: int, block: int,
            lam: float, eps: float, entropy_scale: float):
    dtype = u1_ref.dtype
    r = pl.program_id(0)            # (dir, chan, component) plane
    r1 = r % CL                     # endpoint 1 is the site itself
    idx = pl.program_id(1) * block + jnp.arange(block, dtype=jnp.int32)
    valid = idx < S

    def load(ref, row, other=0.0):
        return plgpu.load(ref.at[row, idx], mask=valid, other=other)

    u1 = load(u1_ref, r1)
    o1 = load(o1_ref, r1, 1.0)
    u2 = load(u2_ref, r)
    o2 = load(o2_ref, r, 1.0)
    p = load(p_ref, r)

    o1e = o1 * _SQRT2
    o2e = o2 * _SQRT2
    delta = u1 - u2
    c = o1e * o1e + o2e * o2e - 2.0 * p * o1e * o2e
    c = jnp.maximum(c, jnp.asarray(jnp.finfo(dtype).tiny, dtype))
    rc = jnp.sqrt(c)

    h0 = h1 = h2 = jnp.zeros((block,), dtype)
    for x, w in nodes:
        d = delta + rc * x
        gv = (-lam * w) * jnp.sqrt(eps + d * d)
        h0 = h0 + gv
        h1 = h1 + gv * x
        h2 = h2 + gv * (x * x - 0.5)

    h1s = _SQRT_PI * h1 / rc
    h2s = _SQRT_PI * h2 / c
    Ei = _SQRT_PI * h0
    Z1 = (o1e - p * o2e) * h1s
    Z2 = (p * o1e - o2e) * h1s
    Sa = _SQRT_PI * h2
    sm_w = (o1e * o1e - o2e * o2e) * h2s
    Sxy = (0.5 * p * (o1e * o1e + o2e * o2e) - o1e * o2e) * h2s

    a = plgpu.load(alpha_ref.at[r1 % L])
    cn = entropy_scale * plgpu.load(t_ref.at[0])
    pr = 1.0 - p * p

    def store(ref, v):
        plgpu.store(ref.at[r, idx], v, mask=valid)

    store(da_ref, Ei * _INV_PI - cn * (_CONST1 + jnp.log(jnp.sqrt(pr) * o1 * o2)))
    store(du1_ref, a * (Z1 - p * Z2) * (_SQRT2 / (o1 * pr)) * _INV_PI)
    store(du2_ref, a * (Z2 - p * Z1) * (_SQRT2 / (o2 * pr)) * _INV_PI)
    store(do1_ref, a * ((Sa + sm_w) * _INV_PI - cn) / o1)
    store(do2_ref, a * ((Sa - sm_w) * _INV_PI - cn) / o2)
    store(dp_ref, a * ((2.0 * Sxy - p * Sa) * _INV_PI + cn * p) / pr)


def edge_reduced_grads_pallas(
    mu, sg, u2e, o2e, rou, alpha, T,
    k1: int, lambdas: float, epsn: float, entropy_scale: float, *,
    block: int = BLOCK, num_warps: int = NUM_WARPS, interpret: bool = False,
) -> GQGrads:
    """Finalized edge gradients over the (dir, chan, L, M, N) edge lattice.

    ``mu``/``sg`` are the (chan, L, M, N) state stacks (endpoint 1 is the
    dir-broadcast of the site itself), ``u2e``/``o2e``/``rou`` the
    (dir, chan, L, M, N) neighbor stacks. ``interpret=True`` runs the
    kernel on the CPU (tests only).
    """
    C, L, M, N = mu.shape
    D = u2e.shape[0]
    S = M * N
    dtype = mu.dtype
    x, w = gauss_hermite(k1)
    nodes = tuple((float(xi), float(wi)) for xi, wi in zip(x, w))

    fn = pl.pallas_call(
        functools.partial(
            _kernel, nodes=nodes, CL=C * L, L=L, S=S, block=block,
            lam=float(lambdas), eps=float(epsn),
            entropy_scale=float(entropy_scale)),
        grid=(D * C * L, pl.cdiv(S, block)),
        out_shape=[jax.ShapeDtypeStruct((D * C * L, S), dtype)] * 6,
        compiler_params=plgpu.CompilerParams(num_warps=num_warps),
        backend="triton",
        interpret=interpret,
        name="edge_reduced_grads",
    )
    outs = fn(
        jnp.asarray(alpha, dtype).reshape(L), jnp.asarray(T, dtype).reshape(1),
        mu.reshape(C * L, S), sg.reshape(C * L, S),
        u2e.reshape(D * C * L, S), o2e.reshape(D * C * L, S),
        rou.reshape(D * C * L, S),
    )
    da, du1, du2, do1, do2, dp = (o.reshape(D, C, L, M, N) for o in outs)
    a5 = jnp.asarray(alpha, dtype).reshape(1, 1, L, 1, 1)
    return GQGrads(da=da, du1=du1, du2=du2, do1=do1, do2=do2, dp=dp,
                   E=a5 * da)
