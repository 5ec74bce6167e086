"""Worker process for the 2-process jax.distributed smoke test.

Run as ``python _multihost_worker.py <process_id> <port>``. Each process
owns 2 forced CPU devices; the pair forms a 4-device global mesh. The
worker initializes the distributed runtime through the launch helper,
builds the globally-sharded problem/state from identical host data, runs
two flagship-path sweeps, and prints the (psum'd, replicated) energy.

Importable from the test (``toy_problem``) — environment/config setup only
runs in __main__ mode, BEFORE jax initializes a backend.
"""

import os
import sys

_IS_MAIN = __name__ == "__main__"
if _IS_MAIN:
    _pid = int(sys.argv[1])
    _port = sys.argv[2]
    os.environ["JAX_PLATFORMS"] = "cpu"
    # Make the repo importable regardless of the parent's environment.
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax  # noqa: E402

if _IS_MAIN:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    # Cross-process CPU collectives (the CPU stand-in for NCCL) and the
    # per-process device count: must be configured before the backend exists
    # (`xla_force_host_platform_device_count` is ignored on the distributed
    # CPU-client path).
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.config.update("jax_num_cpu_devices", 2)

from gqmap_tpu import FlowRange, GQMAPConfig  # noqa: E402
from gqmap_tpu.models.gqmap import init_state, make_problem, make_sweep  # noqa: E402
from gqmap_tpu.parallel.launch import global_mesh, host_to_global, initialize  # noqa: E402
from gqmap_tpu.parallel.mesh import state_sharding  # noqa: E402
from gqmap_tpu.parallel.sharded import problem_sharding  # noqa: E402


def toy_problem(cfg, M=16, N=16):
    r = np.random.default_rng(0)
    I1 = r.uniform(0, 255, (M, N))
    k = np.ones(5) / 5.0
    I1 = np.apply_along_axis(lambda a: np.convolve(a, k, "same"), 0, I1)
    I1 = np.apply_along_axis(lambda a: np.convolve(a, k, "same"), 1, I1)
    I2 = np.roll(I1, 1, axis=1)
    fr = FlowRange(-2.0, 2.0, -2.0, 2.0)
    return make_problem(cfg, I1, I2, fr), init_state(cfg, fr, (M, N)), (M, N)


def main(pid, port):
    initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 4, len(jax.devices())

    mesh = global_mesh()  # (dp, x, y) over all 4 devices
    cfg = GQMAPConfig.tpu_fast(K=3, L=2, dtype="float64", cheb_p=12, cheb_q=8,
                               quad_chunk=0)
    problem, state, shape = toy_problem(cfg)

    psh = problem_sharding(mesh, cfg)
    ssh = state_sharding(mesh)
    gp = host_to_global(problem, psh)
    gs = host_to_global(state, ssh)
    sweep = jax.jit(make_sweep(cfg, shape, sharded=True), in_shardings=(psh, ssh))
    aux = None
    for _ in range(2):
        gs, aux = sweep(gp, gs)
    print(f"ENERGY {float(aux.energy):.12e}", flush=True)
    print(f"PTDMU {float(aux.ptdmu):.12e}", flush=True)


if _IS_MAIN:
    main(_pid, _port)
