"""The GPU path's Python around the kernels: kernel choice, sweep wiring,
compile-cache placement, the coefficient build's precision, the synthetic
pair, and ``chip_smoke.py`` refusing to run without a GPU.

Kernels run in interpret mode here; ``chip_smoke.py`` runs them as
compiled for the card.
"""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gqmap_tpu.config import FlowRange, GQMAPConfig
from gqmap_tpu.models import gqmap as gq
from gqmap_tpu.models.gqmap import init_state, make_problem, make_sweep, use_kernel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def fake_gpu(monkeypatch):
    """Report a GPU backend and run every Pallas call in interpret mode."""
    from jax.experimental import pallas as pl

    real = pl.pallas_call

    def interpreted(*args, **kw):
        kw["interpret"] = True
        return real(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    monkeypatch.setattr(gq.jax, "default_backend", lambda: "gpu")


@pytest.mark.parametrize("backend,sharded,setting,expect", [
    ("gpu", False, "auto", True),
    ("gpu", True, "auto", False),
    ("cpu", False, "auto", False),
    ("cpu", True, "auto", False),
    ("gpu", False, "pallas", True),
    ("gpu", False, "xla", False),
    ("cpu", False, "xla", False),
])
def test_use_kernel(monkeypatch, backend, sharded, setting, expect):
    monkeypatch.setattr(gq.jax, "default_backend", lambda: backend)
    assert use_kernel(setting, "node_kernel", sharded) is expect


@pytest.mark.parametrize("backend,sharded", [("cpu", False), ("gpu", True)])
def test_explicit_pallas_without_kernel_raises(monkeypatch, backend, sharded):
    monkeypatch.setattr(gq.jax, "default_backend", lambda: backend)
    with pytest.raises(ValueError, match="pallas"):
        use_kernel("pallas", "edge_kernel", sharded)


def test_unknown_kernel_setting_raises():
    with pytest.raises(ValueError, match="unknown node_kernel"):
        use_kernel("mosaic", "node_kernel", False)


def test_pallas_on_cpu_raises_at_sweep_build():
    cfg = GQMAPConfig.tpu_fast(node_kernel="pallas")
    with pytest.raises(ValueError, match="node_kernel='pallas'"):
        make_sweep(cfg, (8, 8))


def _toy(cfg, M=12, N=20, seed=0):
    r = np.random.default_rng(seed)
    I1 = r.uniform(0, 255, (M, N))
    k = np.ones(3) / 3
    I1 = np.apply_along_axis(lambda a: np.convolve(a, k, "same"), 0, I1)
    I1 = np.apply_along_axis(lambda a: np.convolve(a, k, "same"), 1, I1)
    I2 = np.roll(I1, 1, axis=1)
    fr = FlowRange(-2.0, 2.0, -2.0, 2.0)
    return make_problem(cfg, I1, I2, fr), init_state(cfg, fr, (M, N)), (M, N)


@pytest.mark.parametrize("node,edge", [("pallas", "xla"), ("xla", "pallas"),
                                       ("auto", "auto")])
def test_sweep_with_kernels_matches_xla_sweep(fake_gpu, node, edge):
    # the kernels wired into the production sweep reproduce the XLA sweep
    kw = dict(dtype="float64", cheb_p=12, cheb_q=6, K=3, L=2)
    ref_cfg = GQMAPConfig.tpu_fast(node_kernel="xla", edge_kernel="xla", **kw)
    cfg = GQMAPConfig.tpu_fast(node_kernel=node, edge_kernel=edge, **kw)
    problem, state, shape = _toy(ref_cfg)
    want, want_aux = make_sweep(ref_cfg, shape)(problem, state)
    got, got_aux = make_sweep(cfg, shape)(problem, state)
    np.testing.assert_allclose(float(got_aux.energy), float(want_aux.energy),
                               rtol=1e-10)
    for f in ("muu", "muv", "sigmau", "sigmav", "pn", "rou"):
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-9, atol=1e-12, err_msg=f)


def test_gspmd_segment_keeps_xla_path(fake_gpu, monkeypatch):
    # a sweep jitted over GSPMD-sharded arrays must not call a kernel
    from gqmap_tpu.kernels import cosine_gq, edge_reduced_gq
    from gqmap_tpu.models.gqmap import make_segment_runner
    from gqmap_tpu.parallel import make_mesh
    from gqmap_tpu.parallel.sharded import shard_problem, shard_state

    def boom(*a, **k):
        raise AssertionError("kernel called under GSPMD")

    monkeypatch.setattr(cosine_gq, "cos_node_grads_pallas", boom)
    monkeypatch.setattr(edge_reduced_gq, "edge_reduced_grads_pallas", boom)
    cfg = GQMAPConfig.tpu_fast(dtype="float64", cheb_p=8, cheb_q=4, K=3, L=2,
                               eval_every=2)
    problem, state, shape = _toy(cfg, M=8, N=8)
    mesh = make_mesh(4)
    seg = make_segment_runner(cfg, shape, mesh=mesh)
    st, n, *_ = seg(shard_problem(problem, mesh), shard_state(state, mesh), 2)
    assert int(n) == 2
    assert np.isfinite(np.asarray(st.muu)).all()


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    from gqmap_tpu.utils import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(ROOT, ".jax_cache")
    try:
        assert enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("term", ["cosine", "chebyshev"])
def test_spectral_build_matches_float64_numpy_dct(term):
    # the float32 coefficient build (one lax.map over the displacement
    # samples, then a HIGHEST-precision DCT einsum) against a float64 NumPy
    # DCT of float64 samples at the same displacement nodes
    from gqmap_tpu.ops import chebyshev, cosine
    from gqmap_tpu.ops.interp import pad_cubic, sample_bicubic

    r = np.random.default_rng(3)
    I1 = r.uniform(0, 255, (10, 14))
    I2 = np.roll(I1, 1, axis=1) + r.normal(0, 2.0, I1.shape)
    lo_u, hi_u, lo_v, hi_v = box = (-2.0, 3.0, -1.5, 1.0)
    P, Q = 12, 6
    f32 = (jnp.asarray(I1, jnp.float32), pad_cubic(jnp.asarray(I2, jnp.float32)))
    if term == "cosine":
        got = cosine.build_cos_data(*f32, 1.0, 1e-6, box, A=P, B=Q).coeffs
        us = lo_u + (np.arange(P) + 0.5) * (hi_u - lo_u) / P
        vs = lo_v + (np.arange(Q) + 0.5) * (hi_v - lo_v) / Q
        Du, Dv = cosine._dct2_matrix(P), cosine._dct2_matrix(Q)
    else:
        got = chebyshev.build_cheb_data(*f32, 1.0, 1e-6, box, P=P, Q=Q).coeffs
        us = (lo_u + hi_u) / 2 + (hi_u - lo_u) / 2 * chebyshev._cheb_nodes(P)
        vs = (lo_v + hi_v) / 2 + (hi_v - lo_v) / 2 * chebyshev._cheb_nodes(Q)
        Du, Dv = chebyshev._dct_matrix(P), chebyshev._dct_matrix(Q)
    assert got.dtype == jnp.float32

    VV = pad_cubic(jnp.asarray(I2))
    jj = 1.0 + np.arange(I1.shape[1])[None, :]
    ii = 1.0 + np.arange(I1.shape[0])[:, None]
    vals = np.stack([np.stack([
        -np.sqrt(1e-6 + (I1 - np.asarray(sample_bicubic(VV, jj + u, ii + v))) ** 2)
        for v in vs]) for u in us])
    want = np.einsum("ap,bq,pqmn->abmn", Du, Dv, vals)
    err = np.max(np.abs(np.asarray(got, np.float64) - want))
    assert err <= 1e-5 * np.max(np.abs(want)), err


def test_synthetic_pair_warps_with_known_flow():
    from scipy import ndimage

    from gqmap_tpu.io.synthetic import synthetic_pair

    I1, I2, flow = synthetic_pair((64, 96), max_disp=3.0, seed=5,
                                  flow_sigma=12.0)
    assert flow.shape == (64, 96, 2)
    assert np.isclose(np.abs(flow).max(), 3.0)
    rows, cols = np.mgrid[0:64, 0:96].astype(float)
    back = ndimage.map_coordinates(I2, [rows + flow[..., 1], cols + flow[..., 0]],
                                   order=3, mode="nearest")
    inner = np.s_[6:-6, 6:-6]
    assert np.abs(back - I1)[inner].max() < 0.02 * 255
    again = synthetic_pair((64, 96), max_disp=3.0, seed=5, flow_sigma=12.0)
    for a, b in zip((I1, I2, flow), again):
        np.testing.assert_array_equal(a, b)


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu_backend():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU backend" in out.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
