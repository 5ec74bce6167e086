"""Multi-process (multi-host stand-in) smoke test.

Spawns 2 OS processes, each owning 2 CPU devices, wired together with
``jax.distributed`` through the launch helper (gloo CPU collectives stand in
for NCCL). The pair runs the flagship (cosine) sweep over a 4-device
global mesh built from globally-sharded arrays (``host_to_global``) and must
produce the same psum'd energy as a single-process run of the identical
problem — exercising ``parallel/launch.py`` end to end (SURVEY.md §2.5's
distributed-backend row; VERDICT round 1 weak #8).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(600)
def test_two_process_distributed_matches_single():
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for i in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()  # exact PIDs we started
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"

    def grab(out, key):
        for line in out.splitlines():
            if line.startswith(key):
                return float(line.split()[1])
        raise AssertionError(f"{key} not found in worker output")

    e0, e1 = grab(outs[0], "ENERGY"), grab(outs[1], "ENERGY")
    d0, d1 = grab(outs[0], "PTDMU"), grab(outs[1], "PTDMU")
    assert np.isfinite(e0)
    assert e0 == e1, (e0, e1)  # replicated psum result, bitwise identical
    assert d0 == d1

    # single-process reference on the identical problem (this pytest process
    # runs the same f64 CPU backend; reduction topology differs -> 1e-9 rel)
    import jax

    from gqmap_tpu import GQMAPConfig
    from gqmap_tpu.models.gqmap import make_sweep
    from _multihost_worker import toy_problem

    cfg = GQMAPConfig.tpu_fast(K=3, L=2, dtype="float64", cheb_p=12, cheb_q=8,
                               quad_chunk=0)
    problem, state, shape = toy_problem(cfg)
    sweep = jax.jit(make_sweep(cfg, shape))
    aux = None
    for _ in range(2):
        state, aux = sweep(problem, state)
    np.testing.assert_allclose(e0, float(aux.energy), rtol=1e-9)
    np.testing.assert_allclose(d0, float(aux.ptdmu), rtol=1e-9)
