"""Bicubic (cubic-convolution) image sampling, MATLAB ``interp2('cubic')``
parity.

The reference inlines MATLAB's cubic-convolution interpolation into its data
term: a padded/extrapolated image ``VV`` (``gqmap_gpu_mixture.m:191-208``,
``getVV``) plus a 16-tap Keys-kernel weighted sum
(``gqmap_gpu_mixture.m:156-179``, ``node_pot``). Accuracy parity of the whole
engine hinges on matching it exactly, so this module replicates both pieces
bit-faithfully (up to float associativity) while expressing the gather the
vectorized way: one batched ``take`` over a stacked tap-offset axis
followed by the fused separable weight contraction.

Coordinates follow MATLAB 1-based convention throughout: a query at
``(Xq, Yq) == (j, i)`` returns ``V[i-1, j-1]`` exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "pad_cubic",
    "sample_bicubic",
    "upsample_cubic",
    "interp2_linear",
    "fill_missing_nearest",
    "prewitt_gradients",
]


def pad_cubic(V: jnp.ndarray) -> jnp.ndarray:
    """Pad a 2-D image by one cubic-extrapolated ring (``getVV``).

    Mirrors ``gqmap_gpu_mixture.m:191-208``: interior copied, then the top
    and bottom rows of *every* column (including the still-zero side
    columns) are cubic-extrapolated, then the left/right columns of every
    row are extrapolated from the (already extrapolated) inner columns, so
    corners match MATLAB's two-pass order exactly.
    """
    V = jnp.asarray(V)
    M, N = V.shape
    out = jnp.zeros((M + 2, N + 2), V.dtype)
    out = out.at[1:-1, 1:-1].set(V)
    top = (3.0 * out[1, :] - 3.0 * out[2, :]) + out[3, :]
    bot = (3.0 * out[-2, :] - 3.0 * out[-3, :]) + out[-4, :]
    out = out.at[0, :].set(top).at[-1, :].set(bot)
    left = (3.0 * out[:, 1] - 3.0 * out[:, 2]) + out[:, 3]
    right = (3.0 * out[:, -2] - 3.0 * out[:, -3]) + out[:, -4]
    out = out.at[:, 0].set(left).at[:, -1].set(right)
    return out


def _cubic_weights(f):
    """The four cubic-convolution weights used by MATLAB interp2.

    These are 2x the Keys (a=-1/2) kernel values at distances
    ``1+f, f, 1-f, 2-f``; the product of an x- and y-weight is therefore 4x,
    compensated by the final ``/4`` in :func:`sample_bicubic`
    (``gqmap_gpu_mixture.m:164-176``).
    """
    w0 = ((2.0 - f) * f - 1.0) * f
    w1 = (3.0 * f - 5.0) * f * f + 2.0
    w2 = ((4.0 - 3.0 * f) * f + 1.0) * f
    w3 = (f - 1.0) * f * f
    return w0, w1, w2, w3


def sample_bicubic(VV: jnp.ndarray, Xq: jnp.ndarray, Yq: jnp.ndarray, pack_pairs: bool = False) -> jnp.ndarray:
    """Sample the cubic-padded image ``VV`` at 1-based query points.

    ``VV`` is ``pad_cubic(V)`` with ``V`` of shape ``(M, N)``;
    ``Xq``/``Yq`` are broadcast-compatible arrays of 1-based column/row
    coordinates. Queries are clamped to ``[1, N] x [1, M]`` exactly as
    ``node_pot`` does (``gqmap_gpu_mixture.m:157-161``).

    Implementation: ONE flat ``take`` over a stacked 16-offset index array,
    then the separable Keys weight contraction — the vectorized equivalent
    of the reference's 16 scalar reads.
    """
    M2, N2 = VV.shape
    M, N = M2 - 2, N2 - 2
    dtype = VV.dtype
    Xq, Yq = jnp.broadcast_arrays(jnp.asarray(Xq, dtype), jnp.asarray(Yq, dtype))
    shape = Xq.shape

    Xq = jnp.clip(Xq, 1.0, N)
    Yq = jnp.clip(Yq, 1.0, M)
    # ix in [1, N-1]: floor for Xq <= N-1, else N-1 (matches the reference's
    # three-way branch since Xq >= 1 after the clamp).
    ix = jnp.minimum(jnp.floor(Xq), N - 1.0)
    iy = jnp.minimum(jnp.floor(Yq), M - 1.0)
    so = Xq - ix
    to = Yq - iy
    # 0-based top-left corner of the 4x4 patch in VV: row iy-1, col ix-1
    # (1-based VV row iy .. iy+3 spans the 4-neighborhood of Yq).
    base = (iy.astype(jnp.int32) - 1) * N2 + (ix.astype(jnp.int32) - 1)

    wy = _cubic_weights(to)
    wx = _cubic_weights(so)
    if pack_pairs and dtype == jnp.float32:
        # Packing horizontally adjacent taps into complex64 halves the
        # gather index count (8 instead of 16).
        Wc = jax.lax.complex(VV[:, :-1], VV[:, 1:]).reshape(-1)
        N2c = N2 - 1
        basec = (iy.astype(jnp.int32) - 1) * N2c + (ix.astype(jnp.int32) - 1)
        offs = np.array(
            [dr * N2c + dc for dc in (0, 2) for dr in range(4)], np.int32
        ).reshape((8,) + (1,) * base.ndim)
        taps = jnp.take(Wc, offs + basec[None])  # (8,) + shape, complex64
        Vq = jnp.zeros(shape, dtype)
        k = 0
        for dc in (0, 2):
            for dr in range(4):
                pair = taps[k]
                Vq = Vq + (jnp.real(pair) * wx[dc] + jnp.imag(pair) * wx[dc + 1]) * wy[dr]
                k += 1
        return Vq * jnp.asarray(0.25, dtype)

    offs = np.array(
        [dr * N2 + dc for dc in range(4) for dr in range(4)], np.int32
    ).reshape((16,) + (1,) * base.ndim)
    taps = jnp.take(VV.reshape(-1), offs + base[None])  # (16,) + shape
    Vq = jnp.zeros(shape, dtype)
    k = 0
    for dc in range(4):
        for dr in range(4):
            Vq = Vq + taps[k] * (wx[dc] * wy[dr])
            k += 1
    return Vq * jnp.asarray(0.25, dtype)


def prewitt_gradients(V: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Prewitt spatial gradients ``(Gx, Gy)`` of a 2-D image.

    ``Gx = dV/dx`` (x = columns), ``Gy = dV/dy`` (y = rows): a central
    difference along the derivative axis smoothed by a 3-tap box along the
    other — the Prewitt operator normalized by 1/6 so the output is a true
    derivative estimate (the reference feeds MATLAB ``imgradientxy(I2,
    'prewitt')`` output, which carries the unnormalized 6x mask scale,
    into its chain rule — ``legacy/gqmap_gpuV3.m:18``; a pure gain on the
    node gradient absorbed there by the hand-tuned step/lambda).
    Replicate-padded edges (one-sided differences degenerate to 0 at the
    boundary columns/rows, matching conv 'same' zero-gradient edges closely
    enough for the frozen border ring).
    """
    Vp = jnp.pad(V, 1, mode="edge")
    box_rows = (Vp[:-2, 1:-1] + Vp[1:-1, 1:-1] + Vp[2:, 1:-1]) / 3.0
    box_cols = (Vp[1:-1, :-2] + Vp[1:-1, 1:-1] + Vp[1:-1, 2:]) / 3.0
    bp = jnp.pad(box_rows, ((0, 0), (1, 1)), mode="edge")
    Gx = (bp[:, 2:] - bp[:, :-2]) / 2.0
    bq = jnp.pad(box_cols, ((1, 1), (0, 0)), mode="edge")
    Gy = (bq[2:, :] - bq[:-2, :]) / 2.0
    return Gx, Gy


def interp2_cubic(V: jnp.ndarray, Xq, Yq) -> jnp.ndarray:
    """MATLAB ``interp2(V, Xq, Yq, 'cubic')`` for in-range 1-based queries."""
    return sample_bicubic(pad_cubic(V), Xq, Yq)


def upsample_cubic(V: jnp.ndarray, rfc: int) -> jnp.ndarray:
    """MATLAB ``interp2(V, rfc, 'cubic')``: 2^rfc-x grid refinement.

    Returns an array of shape ``((M-1)*2^rfc + 1, (N-1)*2^rfc + 1)`` holding
    ``V`` interpolated at spacing ``2^-rfc`` (the ``I2_cont`` trick of
    ``legacy/gqmap_gpuV2.m:10``, kept as a memory/accuracy trade-off knob).
    """
    M, N = V.shape
    r = 1 << rfc
    dtype = V.dtype
    VV = pad_cubic(V)

    # The refined grid is REGULAR: the fractional offset cycles with period
    # r, so the whole upsample is a separable phase-stencil — per phase, a
    # 4-tap weighted sum of shifted arrays (gather-free).
    fr = jnp.arange(r, dtype=dtype) / r                      # (r,)
    w = jnp.stack(_cubic_weights(fr), axis=0) * 0.5          # (4, r)

    # vertical pass: rows 1..M-1 (1-based base iy) x r phases + final row.
    # Base row iy = 1 + i (i in 0..M-2) uses VV rows i .. i+3 (0-based).
    vert = sum(
        w[t][None, :, None] * VV[t : t + M - 1, :][:, None, :] for t in range(4)
    )  # (M-1, r, N+2)
    vert = vert.reshape((M - 1) * r, N + 2)
    vert = jnp.concatenate([vert, VV[M : M + 1, :]], axis=0)  # exact last row
    rows = (M - 1) * r + 1

    # horizontal pass on the vertically refined field.
    horiz = sum(
        w[t][None, None, :] * vert[:, t : t + N - 1][:, :, None] for t in range(4)
    )  # (rows, N-1, r)
    horiz = horiz.reshape(rows, (N - 1) * r)
    out = jnp.concatenate([horiz, vert[:, N : N + 1]], axis=1)
    return out


def interp2_linear(V: jnp.ndarray, Xq, Yq, fill=np.nan) -> jnp.ndarray:
    """MATLAB ``interp2(V, Xq, Yq)`` (bilinear, NaN outside the grid).

    Used by the coarse-to-fine warper (``legacy/optical_flow_ctf.m:31``).
    1-based query coordinates.
    """
    V = jnp.asarray(V)
    M, N = V.shape
    dtype = V.dtype
    Xq, Yq = jnp.broadcast_arrays(jnp.asarray(Xq, dtype), jnp.asarray(Yq, dtype))
    inb = (Xq >= 1) & (Xq <= N) & (Yq >= 1) & (Yq <= M)
    x = jnp.clip(Xq, 1.0, N)
    y = jnp.clip(Yq, 1.0, M)
    ix = jnp.clip(jnp.floor(x), 1, N - 1)
    iy = jnp.clip(jnp.floor(y), 1, M - 1)
    fx = x - ix
    fy = y - iy
    ix0 = ix.astype(jnp.int32) - 1
    iy0 = iy.astype(jnp.int32) - 1
    flat = V.reshape(-1)
    idx = iy0 * N + ix0

    def tap(di, dj):
        return jnp.take(flat, idx + di * N + dj)

    val = (
        tap(0, 0) * (1 - fy) * (1 - fx)
        + tap(0, 1) * (1 - fy) * fx
        + tap(1, 0) * fy * (1 - fx)
        + tap(1, 1) * fy * fx
    )
    return jnp.where(inb, val, jnp.asarray(fill, dtype))


def fill_missing_nearest(A: jnp.ndarray) -> jnp.ndarray:
    """``fillmissing(fillmissing(A,'nearest',1),'nearest',2)``.

    Replaces NaNs by the nearest non-NaN along axis 0, then along axis 1
    (``legacy/optical_flow_ctf.m:32``). MATLAB 'nearest' ties round toward
    the *next* (following) element; we replicate by preferring the
    backward-fill at equal distance.
    """

    def fill_axis(B, axis):
        n = B.shape[axis]
        idx = jnp.arange(n)
        shape = [1, 1]
        shape[axis] = n
        idx = idx.reshape(shape)
        ok = ~jnp.isnan(B)
        # forward fill: last valid index at or before i
        fwd = jax.lax.cummax(jnp.where(ok, idx, -1), axis=axis)
        # backward fill: first valid index at or after i
        bwd = -jax.lax.cummax(
            jnp.where(ok, -idx, -(n + 1)), axis=axis, reverse=True
        )
        dist_f = jnp.where(fwd >= 0, idx - fwd, n + 1)
        dist_b = jnp.where(bwd <= n, bwd - idx, n + 1)
        pick = jnp.where(dist_b <= dist_f, jnp.clip(bwd, 0, n - 1), jnp.clip(fwd, 0, n - 1))
        return jnp.take_along_axis(B, pick, axis=axis)

    return fill_axis(fill_axis(A, 0), 1)
