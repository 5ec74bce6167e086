"""Seeded synthetic frame pair with exactly known dense flow.

Frame 1 is smoothed uniform noise (a textured grayscale image in 0..255).
The flow is a smooth random field scaled to ``max_disp`` pixels. Frame 2 is
frame 1 warped so that ``I2(x + flow(x)) = I1(x)``, the same convention as
the solver's data term and the Middlebury ground truth: ``I2(y) = I1(g(y))``
with ``g`` the inverse of ``x -> x + flow(x)``, found by fixed-point
iteration (the flow's gradient is far below 1, so it converges quickly).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

__all__ = ["synthetic_pair"]


def synthetic_pair(shape=(388, 584), max_disp: float = 4.0, seed: int = 0,
                   texture_sigma: float = 1.5, flow_sigma: float = 40.0):
    """Return ``(I1, I2, flow)``: float64 frames and the (M, N, 2) ``(u, v)``
    ground-truth flow (u along columns, v along rows)."""
    M, N = shape
    rng = np.random.default_rng(seed)
    I1 = ndimage.gaussian_filter(rng.uniform(0.0, 255.0, shape), texture_sigma)
    I1 = 255.0 * (I1 - I1.min()) / (I1.max() - I1.min())

    flow = np.stack([
        ndimage.gaussian_filter(rng.standard_normal(shape), flow_sigma,
                                mode="reflect")
        for _ in range(2)
    ], axis=-1)
    flow *= max_disp / np.abs(flow).max()

    rows, cols = np.mgrid[0:M, 0:N].astype(np.float64)

    def sample(img, r, c):
        return ndimage.map_coordinates(img, [r, c], order=3, mode="nearest")

    # invert x -> x + flow(x): x = y - flow(x), iterated from x = y
    xr, xc = rows.copy(), cols.copy()
    for _ in range(20):
        xr = rows - sample(flow[..., 1], xr, xc)
        xc = cols - sample(flow[..., 0], xr, xc)
    I2 = sample(I1, xr, xc)
    return I1, I2, flow
