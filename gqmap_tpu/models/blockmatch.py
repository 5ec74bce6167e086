"""Block-matching cost-volume flow initializer
(``legacy/optical_flow_temp.m:13-32``).

Cost for integer offset (du, dv): ``conv2(|I2 - shift(I1)|, G, 'same')``
with a normalized Gaussian window (``legacy/Gaussian_filter.m``); the
argmin over the +-U x +-V window gives an integer flow field usable to
initialize the GQMAP solvers.

Vectorized: the (2U+1)(2V+1) shifted absolute-difference maps are stacked
as channels and smoothed with one depthwise ``lax.conv``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["gaussian_window", "block_matching_init"]


def gaussian_window(size: int, sigma: float) -> np.ndarray:
    """Normalized 2-D Gaussian kernel (``legacy/Gaussian_filter.m:1-21``)."""
    half = (size - 1) / 2.0
    x = np.arange(size) - half
    g = np.exp(-(x[None, :] ** 2 + x[:, None] ** 2) / (2.0 * sigma * sigma))
    return g / g.sum()


def block_matching_init(I1, I2, U: int = 7, V: int = 7, ft: int = 3, sigma: float = 1.7):
    """Integer flow init by windowed block matching.

    Returns an (M, N, 2) float array of (u, v) displacements in
    ``[-V, V] x [-U, U]`` (u = columns, v = rows), following the reference's
    ``umt = U+1-fu`` sign convention (``legacy/optical_flow_temp.m:31-32``).
    """
    I1 = jnp.asarray(I1, jnp.float32)
    I2 = jnp.asarray(I2, jnp.float32)
    M, N = I1.shape
    ext = jnp.zeros((M + 2 * U, N + 2 * V), I1.dtype).at[U : M + U, V : N + V].set(I1)

    shifts = []
    for du in range(2 * U + 1):
        for dv in range(2 * V + 1):
            shifts.append(jnp.abs(I2 - jax.lax.dynamic_slice(ext, (du, dv), (M, N))))
    vol = jnp.stack(shifts)  # (C, M, N)

    g = jnp.asarray(gaussian_window(2 * ft + 1, sigma), I1.dtype)
    C = vol.shape[0]
    # depthwise smoothing: treat offsets as batch
    smoothed = jax.lax.conv_general_dilated(
        vol[:, None],                       # (C, 1, M, N)
        g[None, None],                      # (1, 1, k, k)
        window_strides=(1, 1),
        padding="SAME",
    )[:, 0]
    idx = jnp.argmin(smoothed.reshape(C, M, N), axis=0)
    # MATLAB ind2sub([2U+1, 2V+1]) on a linear index over (du, dv) with du
    # fastest: we built du-major, dv-minor, so recover accordingly.
    fu = idx // (2 * V + 1)
    fv = idx % (2 * V + 1)
    u = (V - fv).astype(jnp.float32)
    v = (U - fu).astype(jnp.float32)
    return np.stack([np.asarray(u), np.asarray(v)], axis=-1)
