"""Cross-language checks: JAX ops vs the C++ ports of the MEX components."""

import numpy as np
import jax.numpy as jnp
import pytest

from gqmap_tpu import native

pytestmark = pytest.mark.skipif(not native.available(), reason="no C++ toolchain")


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(5).normal(size=(19, 23)) * 40 + 120


def test_get_vv_matches_jax(image):
    from gqmap_tpu.ops.interp import pad_cubic

    got = native.get_vv(image)
    want = np.asarray(pad_cubic(jnp.asarray(image)))
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-10)


def test_sample_bicubic_matches_jax(image):
    from gqmap_tpu.ops.interp import pad_cubic, sample_bicubic

    VV = native.get_vv(image)
    r = np.random.default_rng(9)
    Xq = r.uniform(-1, 25, 500)
    Yq = r.uniform(-1, 21, 500)
    got = native.sample_bicubic(VV, Xq, Yq)
    want = np.asarray(sample_bicubic(pad_cubic(jnp.asarray(image)), jnp.asarray(Xq), jnp.asarray(Yq)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


def test_mixture_map_matches_jax():
    from gqmap_tpu.ops.mixture import extract_map, mixture_neg_pdf

    r = np.random.default_rng(3)
    M, N, L = 6, 7, 3
    alpha = r.dirichlet(np.ones(L))
    muu = r.normal(size=(M, N, L)) * 2
    muv = r.normal(size=(M, N, L)) * 2
    sgu = r.uniform(0.3, 2.0, (M, N, L))
    sgv = r.uniform(0.3, 2.0, (M, N, L))
    got = native.mixture_map(alpha, muu, sgu, muv, sgv)
    # extract_map uses the (L, M, N) lattice-trailing layout
    to_lmn = lambda a: jnp.moveaxis(jnp.asarray(a), -1, 0)
    want = np.asarray(extract_map(jnp.asarray(alpha), *map(to_lmn, (muu, sgu, muv, sgv))))
    # compare by achieved density (modes can tie) per channel
    for chan, (mu, sg) in enumerate([(muu, sgu), (muv, sgv)]):
        pg = np.asarray(mixture_neg_pdf(jnp.asarray(got[..., chan]), jnp.asarray(alpha), jnp.asarray(mu), jnp.asarray(sg)))
        pw = np.asarray(mixture_neg_pdf(jnp.asarray(want[..., chan]), jnp.asarray(alpha), jnp.asarray(mu), jnp.asarray(sg)))
        np.testing.assert_allclose(pg, pw, rtol=1e-5, atol=1e-8)


def test_flow_to_color_matches_python():
    from gqmap_tpu.ops.flowviz import flow_to_color

    r = np.random.default_rng(1)
    flow = r.normal(size=(12, 14, 2)) * 3
    flow[2, 3] = [1e10, 5.0]
    img, flo, minu, maxu, minv, maxv, unk = native.flow_to_color(flow)
    ref = flow_to_color(flow)
    np.testing.assert_array_equal(img, ref.img)
    np.testing.assert_allclose(flo, ref.flo)
    assert (minu, maxu, minv, maxv) == (ref.minu, ref.maxu, ref.minv, ref.maxv)
    np.testing.assert_array_equal(unk, ref.unknown)


def test_flo_roundtrip_cross(tmp_path):
    from gqmap_tpu.io.flo import read_flo as py_read, write_flo as py_write

    r = np.random.default_rng(2)
    flow = r.normal(size=(9, 11, 2)).astype(np.float32)
    p1 = tmp_path / "a.flo"
    p2 = tmp_path / "b.flo"
    native.write_flo(p1, flow)
    np.testing.assert_array_equal(py_read(p1), flow)
    py_write(p2, flow)
    np.testing.assert_array_equal(native.read_flo(p2), flow)
