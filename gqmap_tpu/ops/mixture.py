"""Per-site 1-D Gaussian-mixture mode extraction (MAP readout).

Vectorized replacement for the reference's compiled ``get_map_mex`` /
``findMap_mex`` binaries (behavioral spec: ``legacy/findMixMax.m:39-70``):
for every lattice site and flow channel, the mode of the 1-D mixture
``sum_l alpha_l N(x; mu_l, sigma_l)`` is found by

1. evaluating the mixture at every component mean (the "spike" candidates),
2. a bounded continuous search on ``[min_l mu_l, max_l mu_l]`` (the
   reference uses MATLAB ``fminbnd``; we use a fixed-iteration golden
   section, fully vectorized over sites), and
3. keeping the continuous optimum only when it strictly beats the best
   spike (``findMixMax.m:54-58``).

Everything is embarrassingly parallel over the (M, N) lattice — a pure
elementwise workload with no gathers.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

__all__ = ["mixture_neg_pdf", "mixture_mode_1d", "extract_map"]

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_GOLD = (math.sqrt(5.0) - 1.0) / 2.0  # 0.618...


def mixture_neg_pdf(x, alpha, mu, sigma):
    """``-sum_l alpha_l * normpdf(x, mu_l, sigma_l)``; broadcasts over sites.

    ``x``: (...); ``alpha``: (L,); ``mu``/``sigma``: (..., L).
    """
    d = (x[..., None] - mu) / sigma
    comp = alpha * jnp.exp(-0.5 * d * d) * (_INV_SQRT_2PI / sigma)
    return -jnp.sum(comp, axis=-1)


def mixture_mode_1d(alpha, mu, sigma, iters: int = 80):
    """Vectorized mixture mode per site; shapes ``mu, sigma: (..., L)``.

    ``iters`` golden-section steps shrink the bracket by 0.618^iters
    (~1e-17 of the initial range at 80), well past MATLAB fminbnd's 1e-4
    tolerance.
    """
    neg = lambda x: mixture_neg_pdf(x, alpha, mu, sigma)

    # Spike candidates: the component means.
    vals = jax.vmap(lambda l: neg(mu[..., l]), out_axes=-1)(jnp.arange(mu.shape[-1]))
    uid = jnp.argmin(vals, axis=-1)
    spike_val = jnp.min(vals, axis=-1)
    spike_x = jnp.take_along_axis(mu, uid[..., None], axis=-1)[..., 0]

    lo = jnp.min(mu, axis=-1)
    hi = jnp.max(mu, axis=-1)

    def body(i, carry):
        a, b, c, d, fc, fd = carry
        # shrink toward the smaller endpoint value
        take_left = fc < fd
        new_a = jnp.where(take_left, a, c)
        new_b = jnp.where(take_left, d, b)
        new_c = new_b - _GOLD * (new_b - new_a)
        new_d = new_a + _GOLD * (new_b - new_a)
        return new_a, new_b, new_c, new_d, neg(new_c), neg(new_d)

    c0 = hi - _GOLD * (hi - lo)
    d0 = lo + _GOLD * (hi - lo)
    a, b, c, d, fc, fd = jax.lax.fori_loop(
        0, iters, body, (lo, hi, c0, d0, neg(c0), neg(d0))
    )
    x_cont = 0.5 * (a + b)
    f_cont = neg(x_cont)

    return jnp.where(f_cont < spike_val, x_cont, spike_x)


def extract_map(alpha, muu, sigmau, muv, sigmav):
    """Flow MAP per pixel: ``(M, N, 2)`` from ``(L, M, N)`` state arrays.

    Equivalent of ``get_map_mex(alf, mu_u, sig_u, mu_v, sig_v)``
    (``gqmap_gpu_mixture.m:53-58``). For ``L == 1`` the mode is the mean.
    """
    if muu.shape[0] == 1:
        return jnp.stack([muu[0], muv[0]], axis=-1)
    u = mixture_mode_1d(alpha, jnp.moveaxis(muu, 0, -1), jnp.moveaxis(sigmau, 0, -1))
    v = mixture_mode_1d(alpha, jnp.moveaxis(muv, 0, -1), jnp.moveaxis(sigmav, 0, -1))
    return jnp.stack([u, v], axis=-1)
