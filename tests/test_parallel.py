"""Shard-count invariance: N-device sharded sweep == single-device sweep.

Runs on the forced-8-device CPU backend (conftest), exercising the same
GSPMD partitioning (collective-permute halos for ``jnp.roll``, psums for the
global reductions) a device mesh uses (SURVEY.md section 4).
"""

import jax
import numpy as np
import pytest
from scipy.ndimage import gaussian_filter

from gqmap_tpu import FlowRange, GQMAPConfig
from gqmap_tpu.models.gqmap import init_state, make_problem, make_sweep
from gqmap_tpu.parallel import (
    make_batched_sharded_sweep,
    make_mesh,
    make_sharded_sweep,
    shard_state,
    stack_states,
)

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)


def problem_and_state(cfg, M=16, N=16, seed=0):
    r = np.random.default_rng(seed)
    I1 = gaussian_filter(r.uniform(0, 255, (M, N)), 1.5)
    I2 = np.roll(I1, 1, axis=1)
    fr = FlowRange(-2, 2, -2, 2)
    problem = make_problem(cfg, I1, I2)._replace(rng=fr)
    state = init_state(cfg, fr, I1.shape)
    return problem, state


def run_n(sweep, problem, state, n):
    aux = None
    for _ in range(n):
        state, aux = sweep(problem, state)
    return state, aux


@pytest.mark.parametrize("dp", [1, 2])
def test_sharded_equals_single(dp):
    cfg = GQMAPConfig.full_mixture(K=5, L=2, dtype="float64")
    problem, state = problem_and_state(cfg)
    ref_sweep = jax.jit(make_sweep(cfg, (16, 16)))
    s_ref, a_ref = run_n(ref_sweep, problem, state, 3)

    mesh = make_mesh(8, dp=dp)  # (dp, x, y); lattice sharded over x,y
    sh_sweep = make_sharded_sweep(cfg, (16, 16), mesh)
    s_sh, a_sh = run_n(sh_sweep, problem, shard_state(state, mesh), 3)

    for name in state._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(s_sh, name)),
            np.asarray(getattr(s_ref, name)),
            rtol=1e-9,
            atol=1e-12,
            err_msg=name,
        )
    np.testing.assert_allclose(float(a_sh.energy), float(a_ref.energy), rtol=1e-9)
    np.testing.assert_allclose(float(a_sh.ptdmu), float(a_ref.ptdmu), rtol=1e-9)


def test_batched_dp_sharded():
    cfg = GQMAPConfig.full_mixture(K=5, L=2, dtype="float64")
    problem, s0 = problem_and_state(cfg, seed=0)
    _, s1 = problem_and_state(cfg, seed=1)
    batch = stack_states([s0, s1])

    mesh = make_mesh(8, dp=2)
    vsweep = make_batched_sharded_sweep(cfg, (16, 16), mesh)
    out, aux = vsweep(problem, shard_state(batch, mesh, batched=True))

    ref_sweep = jax.jit(make_sweep(cfg, (16, 16)))
    r0, x0 = ref_sweep(problem, s0)
    r1, x1 = ref_sweep(problem, s1)
    np.testing.assert_allclose(np.asarray(out.muu[0]), np.asarray(r0.muu), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(out.muu[1]), np.asarray(r1.muu), rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(aux.energy), [float(x0.energy), float(x1.energy)], rtol=1e-9
    )


@pytest.mark.parametrize("data_term", ["cosine", "chebyshev"])
def test_sharded_spectral_terms_equal_single(data_term):
    # the flagship fast path (spectral data terms) under GSPMD: the
    # coefficient field is lattice-sharded (P(None, None, x, y)) rather than
    # replicated, and the sweep must still match the single-device result
    cfg = GQMAPConfig.tpu_fast(
        K=5, L=2, dtype="float64", data_term=data_term,
        cheb_p=24, cheb_q=12, quad_chunk=0,
    )
    r = np.random.default_rng(0)
    I1 = gaussian_filter(r.uniform(0, 255, (16, 16)), 1.5)
    I2 = np.roll(I1, 1, axis=1)
    fr = FlowRange(-2, 2, -2, 2)
    problem = make_problem(cfg, I1, I2, fr)
    state = init_state(cfg, fr, I1.shape)

    ref_sweep = jax.jit(make_sweep(cfg, (16, 16)))
    s_ref, a_ref = run_n(ref_sweep, problem, state, 3)

    from gqmap_tpu.parallel.sharded import shard_problem

    mesh = make_mesh(8, dp=1)
    sh_sweep = make_sharded_sweep(cfg, (16, 16), mesh)
    sp = shard_problem(problem, mesh)
    # the coefficient field really is lattice-sharded, not replicated
    cspec = sp.cheb.coeffs.sharding.spec
    assert tuple(cspec) == (None, None, "x", "y"), cspec
    s_sh, a_sh = run_n(sh_sweep, sp, shard_state(state, mesh), 3)

    for name in state._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(s_sh, name)), np.asarray(getattr(s_ref, name)),
            rtol=1e-9, atol=1e-12, err_msg=name,
        )
    np.testing.assert_allclose(float(a_sh.energy), float(a_ref.energy), rtol=1e-9)


def test_sharded_quadratic_init_flow():
    # legacy_v1 under GSPMD: shard_problem must carry (and shard) init_flow
    import jax.numpy as jnp
    from gqmap_tpu.parallel.sharded import shard_problem

    cfg = GQMAPConfig.legacy_v1(K=5, L=1, dtype="float64")
    r = np.random.default_rng(0)
    I1 = gaussian_filter(r.uniform(0, 255, (16, 16)), 1.5)
    I2 = np.roll(I1, 1, axis=1)
    fr = FlowRange(-2, 2, -2, 2)
    init = np.zeros((16, 16, 2))
    init[..., 0] = 1.0
    problem = make_problem(cfg, I1, I2, fr)._replace(init_flow=jnp.asarray(init))
    state = init_state(cfg, fr, I1.shape)

    ref_sweep = jax.jit(make_sweep(cfg, (16, 16)))
    s_ref, _ = run_n(ref_sweep, problem, state, 2)
    mesh = make_mesh(8, dp=1)
    sh_sweep = make_sharded_sweep(cfg, (16, 16), mesh)
    s_sh, _ = run_n(sh_sweep, shard_problem(problem, mesh), shard_state(state, mesh), 2)
    np.testing.assert_allclose(
        np.asarray(s_sh.muu), np.asarray(s_ref.muu), rtol=1e-9, atol=1e-12
    )


def test_mesh_for_awkward_shapes():
    # lattice dims that don't divide 8 devices: the shape-aware mesh picks
    # the largest dividing factor pair and stays exact
    from gqmap_tpu.parallel.mesh import make_mesh_for_shape

    cfg = GQMAPConfig.full_mixture(K=3, L=1, dtype="float64")
    problem, state = problem_and_state(cfg, M=18, N=22)
    ref_sweep = jax.jit(make_sweep(cfg, (18, 22)))
    s_ref, _ = run_n(ref_sweep, problem, state, 2)
    mesh = make_mesh_for_shape(18, 22, 8)
    assert mesh.devices.size > 1  # found a nontrivial decomposition
    sh_sweep = make_sharded_sweep(cfg, (18, 22), mesh)
    s_sh, _ = run_n(sh_sweep, problem, shard_state(state, mesh), 2)
    np.testing.assert_allclose(
        np.asarray(s_sh.muu), np.asarray(s_ref.muu), rtol=1e-9, atol=1e-12
    )


def test_solve_with_mesh_matches_single():
    from scipy.ndimage import gaussian_filter as gf
    from gqmap_tpu.models.gqmap import solve

    r = np.random.default_rng(0)
    I1 = gf(r.uniform(0, 255, (16, 16)), 1.5)
    I2 = np.roll(I1, 1, axis=1)
    gt = np.zeros((16, 16, 2))
    gt[..., 0] = 1.0
    fr = FlowRange(-2, 2, -2, 2)
    # few iterations: the dynamics are chaotic (clamp boundaries, 1/(1-p^2)
    # near the correlation clamp), so reduction-order differences amplify
    # quickly; shard-invariance at tight tolerance is separately covered by
    # test_sharded_equals_single over 3 sweeps
    cfg = GQMAPConfig.full_mixture(K=3, L=2, its=6, eval_every=3, dtype="float64")
    a = solve(cfg, I1, I2, gt_flow=gt, flow_range=fr, seed=3)
    mesh = make_mesh(8, dp=1)
    b = solve(cfg, I1, I2, gt_flow=gt, flow_range=fr, seed=3, mesh=mesh)
    np.testing.assert_allclose(b.mu, a.mu, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(b.Energy[:6], a.Energy[:6], rtol=1e-8)
    np.testing.assert_allclose(b.AEPE[2], a.AEPE[2], rtol=1e-7)


def test_solve_with_mesh_super_preset():
    # the patch=4 super lattice under GSPMD solve (VERDICT r04 item 10):
    # the flow lattice is image_shape/patch, so shard divisibility interacts
    # with cfg.patch (the 4x4-aligned shards SURVEY.md 2.5 calls out for
    # gqmap_gpuSuper_mix_entropy.m:11). 32x32 image -> 8x8 lattice over a
    # 2x2 spatial mesh.
    from scipy.ndimage import gaussian_filter as gf
    from gqmap_tpu.models.gqmap import solve

    r = np.random.default_rng(0)
    I1 = gf(r.uniform(0, 255, (32, 32)), 1.5)
    I2 = np.roll(I1, 1, axis=1)
    gt = np.zeros((32, 32, 2))
    gt[..., 0] = 1.0
    fr = FlowRange(-2, 2, -2, 2)
    cfg = GQMAPConfig.super_entropy(
        K=5, L=2, its=6, eval_every=3, dtype="float64",
        data_term="cosine", cheb_p=12, cheb_q=8, edge_quad="reduced",
        quad_chunk=0,
    )
    a = solve(cfg, I1, I2, gt_flow=gt, flow_range=fr, seed=3)
    mesh = make_mesh(4, dp=1)
    b = solve(cfg, I1, I2, gt_flow=gt, flow_range=fr, seed=3, mesh=mesh)
    assert a.map.shape == (8, 8, 2)  # lattice-res map (repelem at scoring)
    np.testing.assert_allclose(b.mu, a.mu, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(b.Energy[:6], a.Energy[:6], rtol=1e-8)
    np.testing.assert_allclose(b.AEPE[2], a.AEPE[2], rtol=1e-7)


def test_sharded_redblack_equals_single():
    # GSPMD path: the parity iotas partition with the lattice, so the
    # checkerboard order must stay shard-count-invariant
    cfg = GQMAPConfig.full_mixture(K=5, L=2, dtype="float64", sweep_order="redblack")
    problem, state = problem_and_state(cfg)
    ref_sweep = jax.jit(make_sweep(cfg, (16, 16)))
    s_ref, a_ref = run_n(ref_sweep, problem, state, 3)
    mesh = make_mesh(8)
    sh_sweep = make_sharded_sweep(cfg, (16, 16), mesh)
    s_sh, a_sh = run_n(sh_sweep, problem, shard_state(state, mesh), 3)
    for name in state._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(s_sh, name)), np.asarray(getattr(s_ref, name)),
            rtol=1e-9, atol=1e-12, err_msg=name,
        )
    np.testing.assert_allclose(float(a_sh.energy), float(a_ref.energy), rtol=1e-9)
