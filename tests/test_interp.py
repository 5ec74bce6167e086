"""Bicubic sampler parity tests against an independent scalar spec.

The scalar spec below is written directly from the MATLAB interp2
cubic-convolution definition (padded array + 16-tap Keys weights,
``gqmap_gpu_mixture.m:156-179, 191-208``) using plain Python loops; the
vectorized path must agree to float64 roundoff.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gqmap_tpu.ops.interp import (
    fill_missing_nearest,
    interp2_linear,
    pad_cubic,
    sample_bicubic,
    upsample_cubic,
)


def scalar_pad(V):
    M, N = V.shape
    VV = np.zeros((M + 2, N + 2))
    VV[1:-1, 1:-1] = V
    for c in range(N + 2):  # top/bottom of every column first
        VV[0, c] = 3 * VV[1, c] - 3 * VV[2, c] + VV[3, c]
        VV[-1, c] = 3 * VV[-2, c] - 3 * VV[-3, c] + VV[-4, c]
    for r in range(M + 2):  # then left/right of every row
        VV[r, 0] = 3 * VV[r, 1] - 3 * VV[r, 2] + VV[r, 3]
        VV[r, -1] = 3 * VV[r, -2] - 3 * VV[r, -3] + VV[r, -4]
    return VV


def scalar_sample(VV, M, N, Xq, Yq):
    Xq = min(max(Xq, 1.0), N)
    Yq = min(max(Yq, 1.0), M)
    ix = 1 if Xq <= 1 else (int(np.floor(Xq)) if Xq <= N - 1 else N - 1)
    iy = 1 if Yq <= 1 else (int(np.floor(Yq)) if Yq <= M - 1 else M - 1)
    so, to = Xq - ix, Yq - iy

    def wts(f):
        return [
            ((2.0 - f) * f - 1.0) * f,
            (3.0 * f - 5.0) * f * f + 2.0,
            ((4.0 - 3.0 * f) * f + 1.0) * f,
            (f - 1.0) * f * f,
        ]

    wx, wy = wts(so), wts(to)
    acc = 0.0
    for c in range(4):
        for r in range(4):
            acc += VV[iy - 1 + r, ix - 1 + c] * wx[c] * wy[r]
    return acc / 4.0


@pytest.fixture(scope="module")
def image(rng=None):
    return np.random.default_rng(7).normal(size=(13, 17)) * 50 + 100


def test_pad_matches_scalar_spec(image):
    got = np.asarray(pad_cubic(jnp.asarray(image)))
    want = scalar_pad(image)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-10)


def test_sample_matches_scalar_spec(image):
    M, N = image.shape
    VVs = scalar_pad(image)
    VV = pad_cubic(jnp.asarray(image))
    r = np.random.default_rng(3)
    Xq = r.uniform(-2, N + 3, 200)  # includes out-of-range -> clamped
    Yq = r.uniform(-2, M + 3, 200)
    got = np.asarray(sample_bicubic(VV, jnp.asarray(Xq), jnp.asarray(Yq)))
    want = np.array([scalar_sample(VVs, M, N, x, y) for x, y in zip(Xq, Yq)])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


def test_integer_point_exactness(image):
    M, N = image.shape
    jj, ii = np.meshgrid(np.arange(1, N + 1, dtype=float), np.arange(1, M + 1, dtype=float))
    got = np.asarray(sample_bicubic(pad_cubic(jnp.asarray(image)), jnp.asarray(jj), jnp.asarray(ii)))
    np.testing.assert_allclose(got, image, rtol=1e-13, atol=1e-10)


def test_quadratic_reproduction():
    # Keys a=-1/2 cubic convolution reproduces quadratics exactly (interior)
    yy, xx = np.mgrid[1:21, 1:26].astype(float)
    Q = 0.3 * xx**2 - 0.1 * xx * yy + 0.25 * yy**2 + 2 * xx - yy + 7
    r = np.random.default_rng(5)
    Xq = r.uniform(2, 24, 50)
    Yq = r.uniform(2, 19, 50)
    got = np.asarray(sample_bicubic(pad_cubic(jnp.asarray(Q)), jnp.asarray(Xq), jnp.asarray(Yq)))
    want = 0.3 * Xq**2 - 0.1 * Xq * Yq + 0.25 * Yq**2 + 2 * Xq - Yq + 7
    np.testing.assert_allclose(got, want, rtol=1e-11)


def test_upsample_cubic_grid(image):
    fine = np.asarray(upsample_cubic(jnp.asarray(image), 2))
    M, N = image.shape
    assert fine.shape == ((M - 1) * 4 + 1, (N - 1) * 4 + 1)
    # coarse grid points preserved
    np.testing.assert_allclose(fine[::4, ::4], image, rtol=1e-12, atol=1e-9)


def test_interp2_linear_against_scipy(image):
    from scipy.interpolate import RegularGridInterpolator

    M, N = image.shape
    rgi = RegularGridInterpolator(
        (np.arange(1, M + 1), np.arange(1, N + 1)), image, method="linear"
    )
    r = np.random.default_rng(11)
    Xq = r.uniform(1, N, 100)
    Yq = r.uniform(1, M, 100)
    got = np.asarray(interp2_linear(jnp.asarray(image), jnp.asarray(Xq), jnp.asarray(Yq)))
    want = rgi(np.stack([Yq, Xq], -1))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)
    # out-of-range -> NaN
    out = np.asarray(interp2_linear(jnp.asarray(image), jnp.asarray([0.5]), jnp.asarray([2.0])))
    assert np.isnan(out).all()


def test_fill_missing_nearest():
    A = np.array([[np.nan, 1.0, np.nan], [2.0, np.nan, 3.0], [np.nan, 4.0, np.nan]])
    got = np.asarray(fill_missing_nearest(jnp.asarray(A)))
    assert not np.isnan(got).any()
    # columns with data fill vertically first
    assert got[0, 1] == 1.0 and got[2, 1] == 4.0
    A2 = np.full((3, 3), np.nan)
    A2[1, 1] = 5.0
    got2 = np.asarray(fill_missing_nearest(jnp.asarray(A2)))
    assert (got2 == 5.0).all()


def test_upsample_phase_stencil_matches_direct_sampling(image):
    from gqmap_tpu.ops.interp import pad_cubic, sample_bicubic, upsample_cubic

    fine = np.asarray(upsample_cubic(jnp.asarray(image), 2))
    M, N = image.shape
    r = 4
    ys = 1.0 + np.arange((M - 1) * r + 1) / r
    xs = 1.0 + np.arange((N - 1) * r + 1) / r
    direct = np.asarray(
        sample_bicubic(pad_cubic(jnp.asarray(image)), jnp.asarray(xs)[None, :], jnp.asarray(ys)[:, None])
    )
    np.testing.assert_allclose(fine, direct, rtol=1e-12, atol=1e-9)


def test_pack_pairs_variant_matches(image):
    VV = pad_cubic(jnp.asarray(image, jnp.float32))
    r = np.random.default_rng(13)
    M, N = image.shape
    Xq = jnp.asarray(r.uniform(-1, N + 2, 300), jnp.float32)
    Yq = jnp.asarray(r.uniform(-1, M + 2, 300), jnp.float32)
    a = np.asarray(sample_bicubic(VV, Xq, Yq))
    b = np.asarray(sample_bicubic(VV, Xq, Yq, pack_pairs=True))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
