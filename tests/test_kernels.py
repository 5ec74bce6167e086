"""GPU reduced-edge kernel parity vs the XLA ops path (interpret mode)."""

import numpy as np
import jax.numpy as jnp
import pytest

from gqmap_tpu.kernels.edge_reduced_gq import edge_reduced_grads_pallas
from gqmap_tpu.ops.gq import EDGE, finalize, gq_accumulate_diff
from gqmap_tpu.ops.potentials import make_edge_pot_diff
from gqmap_tpu.ops.quadrature import build_table_1d


def _edge_case(L, M, N, seed, dtype=jnp.float32):
    r = np.random.default_rng(seed)
    mu = jnp.asarray(r.normal(size=(2, L, M, N)), dtype)
    sg = jnp.asarray(r.uniform(0.5, 3, (2, L, M, N)), dtype)
    u2e = jnp.stack([jnp.roll(mu, -1, -2), jnp.roll(mu, -1, -1)], axis=0)
    o2e = jnp.stack([jnp.roll(sg, -1, -2), jnp.roll(sg, -1, -1)], axis=0)
    rou = jnp.asarray(r.uniform(-0.9, 0.9, (2, 2, L, M, N)), dtype)
    alpha = jnp.asarray(r.dirichlet(np.ones(L)), dtype)
    return mu, sg, u2e, o2e, rou, alpha


def _xla_edge(mu, sg, u2e, o2e, rou, alpha, T, k1):
    tab1 = build_table_1d(k1, dtype=np.dtype(mu.dtype))
    gd = make_edge_pot_diff(5.0, 1e-6)
    raw = gq_accumulate_diff(gd, mu[None], u2e, sg[None], o2e, rou, tab1)
    return finalize(raw, alpha.reshape(-1, 1, 1), sg[None], o2e, rou, T, EDGE)


def test_edge_reduced_pallas_matches_ops():
    # fused reduced-edge kernel (quad + transform + finalize in registers)
    # vs the XLA gq_accumulate_diff + finalize path, on the edge-lattice
    # shapes, f32 as on the card
    mu, sg, u2e, o2e, rou, alpha = _edge_case(3, 17, 23, seed=1)
    T = jnp.asarray(0.17, jnp.float32)
    want = _xla_edge(mu, sg, u2e, o2e, rou, alpha, T, 13)
    got = edge_reduced_grads_pallas(
        mu, sg, u2e, o2e, rou, alpha, T, 13, 5.0, 1e-6, EDGE,
        block=64, interpret=True,
    )
    for name in want._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)),
            np.asarray(getattr(want, name)),
            rtol=2e-5,
            atol=2e-4,
            err_msg=name,
        )


@pytest.mark.parametrize("L,M,N,block,k1", [
    (1, 5, 7, 32, 9),      # one component, tail far from a full block
    (2, 3, 452, 512, 21),  # flagship row width and edge order, one block/plane
    (3, 9, 31, 128, 21),   # three components, several blocks with a tail
])
def test_edge_reduced_pallas_f64_ragged(L, M, N, block, k1):
    # f64 parity to roundoff across ragged site tails, component counts and
    # block sizes; T != 0 exercises the Bethe edge-entropy terms
    mu, sg, u2e, o2e, rou, alpha = _edge_case(L, M, N, seed=L + M,
                                              dtype=jnp.float64)
    T = jnp.asarray(0.3, jnp.float64)
    want = _xla_edge(mu, sg, u2e, o2e, rou, alpha, T, k1)
    got = edge_reduced_grads_pallas(
        mu, sg, u2e, o2e, rou, alpha, T, k1, 5.0, 1e-6, EDGE,
        block=block, interpret=True,
    )
    for name in want._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)),
            np.asarray(getattr(want, name)),
            rtol=1e-10, atol=1e-10, err_msg=name,
        )
