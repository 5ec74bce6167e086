"""GPU cosine-mode-sum kernel vs the XLA reference path (interpret mode)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from gqmap_tpu.kernels.cosine_gq import (
    _RECUR_BOUND, _THETA, _adaptive_trip, cos_mode_sums_pallas,
    cos_node_grads_pallas,
)
from gqmap_tpu.ops.cosine import _mode_sums, cos_node_grads
from gqmap_tpu.ops.gq import NODE

from test_cosine import _rand_sites, _toy_cosdata

NAMES = ("E0", "A1", "A2", "Aa", "Ab", "Ax")


def _check_sums(got, want, rtol=1e-9, atol=1e-9, tag=""):
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), rtol=rtol, atol=atol,
            err_msg=f"{name} {tag}",
        )


def test_mode_sums_match_xla():
    cos = _toy_cosdata(A=20, B=6, M=16, N=24, seed=7)
    u1, u2, o1, o2, p = _rand_sites(M=16, N=24, L=3, seed=8, sig_hi=2.0)
    want, _ = _mode_sums(cos, u1, u2, o1, o2, p, a_block=8, want_grads=True)
    got = cos_mode_sums_pallas(cos, u1, u2, o1, o2, p, interpret=True)
    _check_sums(got, want, rtol=1e-10, atol=1e-10)


def test_mode_sums_ragged_degree_and_lattice():
    # A not a multiple of the XLA scan block and a lattice whose site count
    # is not a multiple of the kernel block
    cos = _toy_cosdata(A=13, B=5, M=12, N=37, seed=9)
    u1, u2, o1, o2, p = _rand_sites(M=12, N=37, L=2, seed=10, sig_hi=1.5)
    want, _ = _mode_sums(cos, u1, u2, o1, o2, p, a_block=4, want_grads=True)
    got = cos_mode_sums_pallas(cos, u1, u2, o1, o2, p, block=64,
                               interpret=True)
    _check_sums(got, want, rtol=1e-10, atol=1e-10)


def test_mode_sums_ragged_site_tail_452_wide():
    # the flagship lattice width: 452 sites per row, flattened, with a
    # masked tail in the last program (3 * 452 = 1356 = 5 * 256 + 76)
    cos = _toy_cosdata(A=8, B=4, M=3, N=452, seed=23)
    u1, u2, o1, o2, p = _rand_sites(M=3, N=452, L=2, seed=24, sig_hi=1.0)
    want, _ = _mode_sums(cos, u1, u2, o1, o2, p, a_block=8, want_grads=True)
    got = cos_mode_sums_pallas(cos, u1, u2, o1, o2, p, block=256,
                               interpret=True)
    _check_sums(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("block", [32, 128, 512])
def test_mode_sums_independent_of_block(block):
    # blocks only regroup sites (and the block-wide cutoff/recurrence
    # choices), so every block size gives the XLA sums
    cos = _toy_cosdata(A=10, B=4, M=9, N=31, seed=25)
    u1, u2, o1, o2, p = _rand_sites(M=9, N=31, L=2, seed=26, sig_hi=1.2)
    want, _ = _mode_sums(cos, u1, u2, o1, o2, p, a_block=8, want_grads=True)
    got = cos_mode_sums_pallas(cos, u1, u2, o1, o2, p, block=block,
                               num_warps=4, interpret=True)
    _check_sums(got, want, tag=f"block {block}")


def test_block_must_be_power_of_two():
    cos = _toy_cosdata(A=4, B=3, M=4, N=4, seed=1)
    u1, u2, o1, o2, p = _rand_sites(M=4, N=4, L=1, seed=2)
    with pytest.raises(ValueError, match="power of two"):
        cos_mode_sums_pallas(cos, u1, u2, o1, o2, p, block=96, interpret=True)


def test_node_grads_match_xla():
    cos = _toy_cosdata(A=16, B=4, M=16, N=16, seed=11)
    u1, u2, o1, o2, p = _rand_sites(M=16, N=16, L=3, seed=12, sig_hi=2.0)
    a = jnp.ones((3, 1, 1)) / 3.0
    want = cos_node_grads(cos, u1, u2, o1, o2, p, a, 0.25, NODE)
    got = cos_node_grads_pallas(cos, u1, u2, o1, o2, p, a, 0.25, NODE,
                                interpret=True)
    for g, w, name in zip(got, want, want._fields):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), rtol=1e-9, atol=1e-11, err_msg=name
        )


def test_mode_sums_adaptive_cutoff_truncates_safely():
    # big sigmas => the e^{-theta^2/2} cutoff clips most of the u-degree
    # axis; the truncated tail is analytically < e^-50, so parity with the
    # untruncated XLA sums must still hold to fp roundoff
    cos = _toy_cosdata(A=64, B=4, M=16, N=16, seed=13)
    u1, u2, o1, o2, p = _rand_sites(M=16, N=16, L=2, seed=14, sig_hi=3.0)
    o1 = o1 + 2.0  # push sigma up so the cutoff engages well below A
    want, _ = _mode_sums(cos, u1, u2, o1, o2, p, a_block=8, want_grads=True)
    got = cos_mode_sums_pallas(cos, u1, u2, o1, o2, p, block=64,
                               interpret=True)
    _check_sums(got, want)


def test_node_grads_adaptive_ragged():
    # ragged site tail + adaptive cutoff: the masked min must keep every
    # real mode (masked lanes read zero scale and would zero the cutoff's
    # denominator)
    cos = _toy_cosdata(A=13, B=5, M=12, N=16, seed=9)
    u1, u2, o1, o2, p = _rand_sites(M=12, N=16, L=2, seed=10, sig_hi=1.5)
    o1 = o1 + 1.0
    a = jnp.ones((2, 1, 1)) / 2.0
    want = cos_node_grads(cos, u1, u2, o1, o2, p, a, 0.25, NODE)
    got = cos_node_grads_pallas(cos, u1, u2, o1, o2, p, a, 0.25, NODE,
                                block=128, interpret=True)
    for g, w, name in zip(got, want, want._fields):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), rtol=1e-8, atol=1e-10, err_msg=name
        )


def test_mode_sums_recur_tight_sigma_matches_xla():
    # tight sigma => the block-wide safety bound holds and the zero-exp
    # recurrence body runs; same math, different association
    cos = _toy_cosdata(A=24, B=6, M=16, N=24, seed=15)
    u1, u2, o1, o2, p = _rand_sites(M=16, N=24, L=3, seed=16, sig_hi=0.08)
    want, _ = _mode_sums(cos, u1, u2, o1, o2, p, a_block=8, want_grads=True)
    got = cos_mode_sums_pallas(cos, u1, u2, o1, o2, p, interpret=True)
    _check_sums(got, want)


def test_mode_sums_recur_wide_sigma_falls_back():
    # wide sigma + strong correlation is exactly where the recurrence would
    # underflow-then-recover; the safety predicate must route those blocks
    # to the exp body, keeping parity with the XLA sums
    cos = _toy_cosdata(A=48, B=6, M=16, N=16, seed=17)
    u1, u2, o1, o2, p = _rand_sites(M=16, N=16, L=2, seed=18, sig_hi=3.0)
    o1 = o1 + 2.0
    p = jnp.clip(p * 1.1, -0.99999, 0.99999)
    want, _ = _mode_sums(cos, u1, u2, o1, o2, p, a_block=8, want_grads=True)
    got = cos_mode_sums_pallas(cos, u1, u2, o1, o2, p, interpret=True)
    _check_sums(got, want)


@pytest.mark.parametrize("s1,s2,p", [(0.05, 0.05, 0.9), (0.3, 0.2, -0.5),
                                     (1.5, 0.4, 0.0), (3.0, 3.0, 0.99)])
def test_adaptive_trip_bounds_every_skipped_mode(s1, s2, p):
    # every mode at or beyond the trip count weighs below e^{-theta^2/2}
    # (both W- and W+), and the trip never exceeds A
    A, B = 64, 16
    trip = int(_adaptive_trip(jnp.asarray(s1), jnp.asarray(s2), A, B))
    assert 0 < trip <= A
    a = np.arange(trip, A)[:, None]
    b = np.arange(B)[None, :]
    h = -0.5 * (a * s1 - b * s2) ** 2
    for sign in (-1.0, 1.0):
        W = np.exp(h - a * b * s1 * s2 * (1.0 + sign * p))
        assert (W < math.exp(-0.5 * _THETA**2)).all()


@pytest.mark.parametrize("s1,s2,p", [(0.05, 0.05, 0.9), (0.1, 0.08, -0.99)])
def test_recurrence_matches_direct_weights(s1, s2, p):
    # where the block-wide bound admits the recurrence, the multiplicative
    # weights it carries equal the directly evaluated exponentials
    A, B = 64, 16
    trip = int(_adaptive_trip(jnp.asarray(s1), jnp.asarray(s2), A, B))
    assert trip * s1 + B * s2 < _RECUR_BOUND
    for a in range(trip):
        wm = wp = math.exp(-0.5 * (a * s1) ** 2)
        fm = math.exp(a * s1 * s2 * p - 0.5 * s2 * s2)
        fp = math.exp(-a * s1 * s2 * p - 0.5 * s2 * s2)
        r = math.exp(-s2 * s2)
        for b in range(B):
            h = -0.5 * (a * s1 - b * s2) ** 2
            assert math.isclose(wm, math.exp(h - a * b * s1 * s2 * (1 - p)),
                                rel_tol=1e-12)
            assert math.isclose(wp, math.exp(h - a * b * s1 * s2 * (1 + p)),
                                rel_tol=1e-12)
            wm, fm = wm * fm, fm * r
            wp, fp = wp * fp, fp * r


def test_float32_kernel_within_smoke_tolerance():
    # the kernel in float32 against the float64 XLA sums, relative to each
    # sum's largest magnitude: the budget chip_smoke.py holds the card to
    from test_gpu_path import load_chip_smoke

    KERNEL_RTOL = load_chip_smoke().KERNEL_RTOL
    cos = _toy_cosdata(A=32, B=16, M=8, N=40, seed=27)
    u1, u2, o1, o2, p = _rand_sites(M=8, N=40, L=3, seed=28, sig_hi=1.0)
    want, _ = _mode_sums(cos, u1, u2, o1, o2, p, a_block=8, want_grads=True)
    f32 = [jnp.asarray(x, jnp.float32) for x in (u1, u2, o1, o2, p)]
    cos32 = cos._replace(**{k: jnp.asarray(v, jnp.float32)
                            for k, v in cos._asdict().items()})
    got = cos_mode_sums_pallas(cos32, *f32, interpret=True)
    for g, w, name in zip(got, want, NAMES):
        assert g.dtype == jnp.float32
        err = np.max(np.abs(np.asarray(g, np.float64) - np.asarray(w)))
        assert err <= KERNEL_RTOL * np.max(np.abs(np.asarray(w))), name
