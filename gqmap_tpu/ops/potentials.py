"""MRF potential functions for the dense-correspondence model.

Node (data) potential: Charbonnier-robust brightness constancy against a
bicubically sampled second frame (``gqmap_gpu_mixture.m:156-179``). Edge
(smoothness) potential: Charbonnier on the neighbor flow difference
(``:180-182``). The "Super" variant sums the node potential over a PxP patch
of image pixels per flow node (``gqmap_gpuSuper_mix_entropy.m:94-105``).

Layout convention: the lattice axes (M, N) are the TRAILING two axes of
every array; quadrature-chunk / mixture-component / edge axes lead, so
every elementwise pass over the lattice is contiguous.

Legacy potential families are kept as first-class options so the framework
subsumes the whole solver lineage:

* ``make_node_pot_nearest`` — nearest lookup into a 2^rfc-x cubic-upsampled
  frame (``legacy/gqmap_gpuV2.m:10,107``, ``legacy/gqmap_ctf.m:10,96``).
* quadratic node toward an init flow + truncated-quadratic edges
  (``legacy/gqmap_cpu.m:22-23,43``).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from .interp import sample_bicubic

__all__ = [
    "make_node_pot_bicubic",
    "make_node_pot_nearest",
    "make_node_pot_quadratic",
    "make_node_pot_windowed",
    "make_node_pot_nearest_chain",
    "make_edge_pot",
    "make_edge_pot_diff",
    "make_edge_pot_truncquad",
    "make_edge_pot_truncquad_diff",
]


def make_node_pot_bicubic(
    I1: jnp.ndarray,
    VV: jnp.ndarray,
    lambdad: float,
    epsn: float,
    patch: int = 1,
    origin=None,
    local_image_shape=None,
    pack: bool = False,
) -> Callable:
    """Return ``f(x1, x2) -> node potential`` over the flow lattice.

    ``I1`` is the (Mo, No) first frame; ``VV = pad_cubic(I2)``. The returned
    callable accepts displacement sample arrays of shape
    ``lead + (M, N)`` where ``(M, N) = (Mo, No) / patch`` and ``lead`` is
    any number of leading broadcast axes (quadrature chunk, mixture
    components, ...). For ``patch > 1`` each flow node sums the data
    potential over its ``patch x patch`` pixel block (super lattice).
    """
    Mo, No = I1.shape
    dtype = I1.dtype
    lam = jnp.asarray(lambdad, dtype)
    eps = jnp.asarray(epsn, dtype)
    # Distributed (shard_map) use: `origin` = traced (row0, col0) image-pixel
    # offset of this shard and `local_image_shape` its owned extent; frame 1
    # is then sliced locally while the padded frame 2 stays global (bounded-
    # range bicubic gathers may touch an arbitrary window).
    Ml, Nl = local_image_shape if local_image_shape is not None else (Mo, No)

    def f(x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
        # 1-based coordinate grids as iota ops (NOT trace-time constants:
        # embedded array constants are pathologically slow on some runtimes)
        jj = 1.0 + jax.lax.broadcasted_iota(dtype, (1, Nl), 1)
        ii = 1.0 + jax.lax.broadcasted_iota(dtype, (Ml, 1), 0)
        I1l = I1
        if origin is not None:
            r0, c0 = origin
            jj = jj + c0.astype(dtype)
            ii = ii + r0.astype(dtype)
            I1l = jax.lax.dynamic_slice(I1, (r0, c0), (Ml, Nl))
        if patch > 1:
            x1 = jnp.repeat(jnp.repeat(x1, patch, axis=-2), patch, axis=-1)
            x2 = jnp.repeat(jnp.repeat(x2, patch, axis=-2), patch, axis=-1)
        Xq = jj + x1  # sample_bicubic clamps to [1, No] (gqmap_gpu_mixture.m:157)
        Yq = ii + x2
        Vq = sample_bicubic(VV, Xq, Yq, pack_pairs=pack)
        npt = -lam * jnp.sqrt(eps + (I1l - Vq) ** 2)
        if patch > 1:
            M, N = Ml // patch, Nl // patch
            lead = npt.shape[:-2]
            npt = npt.reshape(lead + (M, patch, N, patch)).sum(axis=(-3, -1))
        return npt

    return f


def make_node_pot_nearest(
    I1: jnp.ndarray,
    I2_cont: jnp.ndarray,
    lambdad: float,
    epsn: float,
    rfc: int,
    origin=None,
    local_image_shape=None,
) -> Callable:
    """Legacy data term: nearest lookup into the 2^rfc-x upsampled frame.

    ``I2_cont = upsample_cubic(I2, rfc)``; lookup index
    ``round((pos - 1) * 2^rfc + 1)`` clamped to the fine grid
    (``legacy/gqmap_ctf.m:96``). MATLAB ``round`` is half-away-from-zero;
    positions are >= ~1 so ``floor(x + 0.5)`` reproduces it.
    """
    Mo, No = I1.shape
    MM, NN = I2_cont.shape
    dtype = I1.dtype
    lam = jnp.asarray(lambdad, dtype)
    eps = jnp.asarray(epsn, dtype)
    r = float(1 << rfc)
    flat = I2_cont.reshape(-1)
    Ml, Nl = local_image_shape if local_image_shape is not None else (Mo, No)

    def f(x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
        jj = 1.0 + jax.lax.broadcasted_iota(dtype, (1, Nl), 1)
        ii = 1.0 + jax.lax.broadcasted_iota(dtype, (Ml, 1), 0)
        I1l = I1
        if origin is not None:
            r0, c0 = origin
            jj = jj + c0.astype(dtype)
            ii = ii + r0.astype(dtype)
            I1l = jax.lax.dynamic_slice(I1, (r0, c0), (Ml, Nl))
        ci = jnp.clip(jnp.floor((ii + x2 - 1.0) * r + 1.5), 1, MM).astype(jnp.int32) - 1
        cj = jnp.clip(jnp.floor((jj + x1 - 1.0) * r + 1.5), 1, NN).astype(jnp.int32) - 1
        Vq = jnp.take(flat, ci * NN + cj)
        return -lam * jnp.sqrt(eps + (I1l - Vq) ** 2)

    return f


def make_node_pot_windowed(
    I1: jnp.ndarray,
    tab: jnp.ndarray,
    lambdad: float,
    epsn: float,
    rg: int,
    base: str,
    rfc: int = 6,
    origin=None,
    local_image_shape=None,
    pack: bool = False,
) -> Callable:
    """Overlapping-window data cost (``legacy/gqmap_cpuV2.m:29-33``,
    ``gqmap_cpuV3.m:30-32``): the node potential at pixel (i, j) is the MEAN
    Charbonnier cost over its (2rg+1)^2 window, the candidate displacement
    shared across the window. ``base`` picks the frame-2 sampler: "bicubic"
    (on-the-fly cubic, cpuV3; ``tab = pad_cubic(I2)``) or "nearest" (lookup
    into the 2^rfc-x upsampled frame, cpuV2; ``tab = upsample_cubic``).

    Cost is (2rg+1)^2 x the plain term — a parity/robustness mode, not the
    flagship path (the spectral terms absorb the window into their
    coefficient build at zero sweep-time cost).

    Distributed (shard_map) use: frame 1 stays replicated, so window taps
    reaching across shard cuts read the true neighbor rows; the rg-pad of
    the global frame only affects the frozen border ring.
    """
    Mo, No = I1.shape
    dtype = I1.dtype
    lam = jnp.asarray(lambdad, dtype)
    eps = jnp.asarray(epsn, dtype)
    W = (2 * rg + 1) ** 2
    Ml, Nl = local_image_shape if local_image_shape is not None else (Mo, No)
    if base == "nearest":
        MM, NN = tab.shape
        r = float(1 << rfc)
        flat = tab.reshape(-1)

        def sample(Xq, Yq):
            ci = jnp.clip(jnp.floor((Yq - 1.0) * r + 1.5), 1, MM).astype(jnp.int32) - 1
            cj = jnp.clip(jnp.floor((Xq - 1.0) * r + 1.5), 1, NN).astype(jnp.int32) - 1
            return jnp.take(flat, ci * NN + cj)
    elif base == "bicubic":
        def sample(Xq, Yq):
            return sample_bicubic(tab, Xq, Yq, pack_pairs=pack)
    else:
        raise ValueError(f"windowed data term needs base bicubic|nearest, got {base!r}")

    def f(x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
        jj = 1.0 + jax.lax.broadcasted_iota(dtype, (1, Nl), 1)
        ii = 1.0 + jax.lax.broadcasted_iota(dtype, (Ml, 1), 0)
        if origin is not None:
            r0, c0 = origin
            jj = jj + c0.astype(dtype)
            ii = ii + r0.astype(dtype)
        else:
            r0 = c0 = jnp.asarray(0, jnp.int32)
        I1p = jnp.pad(I1, rg, mode="edge")
        acc = jnp.zeros(jnp.broadcast_shapes(x1.shape, x2.shape, (Ml, Nl)), dtype)
        for di in range(-rg, rg + 1):
            for dj in range(-rg, rg + 1):
                I1s = jax.lax.dynamic_slice(I1p, (r0 + (rg + di), c0 + (rg + dj)), (Ml, Nl))
                Vq = sample(jj + dj + x1, ii + di + x2)
                acc = acc + jnp.sqrt(eps + (I1s - Vq) ** 2)
        return -lam * acc / W

    return f


def make_node_pot_nearest_chain(
    I1: jnp.ndarray,
    I2_cont: jnp.ndarray,
    I2u_cont: jnp.ndarray,
    I2v_cont: jnp.ndarray,
    lambdad: float,
    epsn: float,
    rfc: int,
    origin=None,
    local_image_shape=None,
) -> Callable:
    """Chain-rule node term for the image-gradient (Prewitt) estimator
    family (``legacy/gqmap_gpuV3.m:91-125``): returns
    ``fg(x1, x2) -> (f, df/dx1, df/dx2)`` where the spatial derivatives of
    frame 2 come from precomputed (upsampled) Prewitt gradient fields,

        f       = -lambda_d sqrt(eps + diff^2),  diff = I1 - I2(pos)
        df/dx1  =  lambda_d diff I2u(pos) / sqrt(eps + diff^2)

    (``I2u = dI2/dx`` with x = columns; the reference feeds MATLAB's
    unnormalized imgradientxy output — here the Prewitt fields are scaled to
    true central-difference derivatives so the estimator agrees with the
    Stein family in expectation, see ``ops.interp.prewitt_gradients``).
    """
    Mo, No = I1.shape
    MM, NN = I2_cont.shape
    dtype = I1.dtype
    lam = jnp.asarray(lambdad, dtype)
    eps = jnp.asarray(epsn, dtype)
    r = float(1 << rfc)
    flat = I2_cont.reshape(-1)
    flatu = I2u_cont.reshape(-1)
    flatv = I2v_cont.reshape(-1)
    Ml, Nl = local_image_shape if local_image_shape is not None else (Mo, No)

    def fg(x1: jnp.ndarray, x2: jnp.ndarray):
        jj = 1.0 + jax.lax.broadcasted_iota(dtype, (1, Nl), 1)
        ii = 1.0 + jax.lax.broadcasted_iota(dtype, (Ml, 1), 0)
        I1l = I1
        if origin is not None:
            r0, c0 = origin
            jj = jj + c0.astype(dtype)
            ii = ii + r0.astype(dtype)
            I1l = jax.lax.dynamic_slice(I1, (r0, c0), (Ml, Nl))
        ci = jnp.clip(jnp.floor((ii + x2 - 1.0) * r + 1.5), 1, MM).astype(jnp.int32) - 1
        cj = jnp.clip(jnp.floor((jj + x1 - 1.0) * r + 1.5), 1, NN).astype(jnp.int32) - 1
        idx = ci * NN + cj
        Vq = jnp.take(flat, idx)
        Gu = jnp.take(flatu, idx)
        Gv = jnp.take(flatv, idx)
        diff = I1l - Vq
        deno = jnp.sqrt(eps + diff * diff)
        f = -lam * deno
        s = lam * diff / deno
        return f, s * Gu, s * Gv

    return fg


def make_edge_pot(lambdas: float, epsn: float) -> Callable:
    """Charbonnier smoothness: ``-lambdas * sqrt(epsn + (x1-x2)^2)``."""

    def f(x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
        lam = jnp.asarray(lambdas, x1.dtype)
        eps = jnp.asarray(epsn, x1.dtype)
        return -lam * jnp.sqrt(eps + (x1 - x2) ** 2)

    return f


def make_edge_pot_diff(lambdas: float, epsn: float) -> Callable:
    """Difference form of the Charbonnier edge potential: ``gd(d) = f(d, 0)``.

    Both reference edge families depend only on ``x1 - x2``; this form feeds
    the 1-D reduced quadrature (:func:`gqmap_tpu.ops.gq.gq_accumulate_diff`).
    """

    def gd(d: jnp.ndarray) -> jnp.ndarray:
        lam = jnp.asarray(lambdas, d.dtype)
        eps = jnp.asarray(epsn, d.dtype)
        return -lam * jnp.sqrt(eps + d * d)

    return gd


def make_edge_pot_truncquad(gama: float, dta: float) -> Callable:
    """Truncated-quadratic edge potential (``legacy/gqmap_cpu.m:42-44``).

    ``-(x1-x2)^2 / (2*gama)`` with differences beyond ``dta`` truncated
    (zero beyond the cutoff, making the potential robust to discontinuities).
    """

    def f(x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
        d = x2 - x1
        d = jnp.where(jnp.abs(d) > dta, jnp.zeros_like(d), d)
        return -(d * d) / (2.0 * jnp.asarray(gama, x1.dtype))

    return f


def make_edge_pot_truncquad_diff(gama: float, dta: float) -> Callable:
    """Difference form of the truncated-quadratic edge potential."""

    def gd(d: jnp.ndarray) -> jnp.ndarray:
        d = jnp.where(jnp.abs(d) > dta, jnp.zeros_like(d), d)
        return -(d * d) / (2.0 * jnp.asarray(gama, d.dtype))

    return gd


def make_node_pot_quadratic(init_flow, var: float):
    """Quadratic node potential toward a given init flow
    (``legacy/gqmap_cpu.m:22-23``): ``-((fu-x1)^2 + (fv-x2)^2)/(2 var)``.

    The earliest solver family treats the data term as a prior around an
    externally supplied flow (e.g. the block-matching initializer); the
    joint (x1, x2) form with node correlation subsumes the reference's
    per-channel 1-D version.
    """
    fu = init_flow[..., 0]
    fv = init_flow[..., 1]

    def f(x1, x2):
        inv = 1.0 / (2.0 * var)
        du = fu - x1
        dv = fv - x2
        return -(du * du + dv * dv) * inv

    return f
