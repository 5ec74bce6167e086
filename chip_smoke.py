"""Smoke test of the flagship solve on one GPU (``--four``: on four).

Runs the system's main path through its user entry points at full
Middlebury width (388x584, ``tpu_fast``: K=9, L=3, cosine 64x16, reduced
edges) on a seeded synthetic pair with known flow, and checks each phase:

1. each GPU kernel, compiled for the card, against XLA's plain path run in
   float64 on the same card, in both sigma regimes;
2. one full production sweep in float32 against the same sweep in float64
   on XLA;
3. a 900-sweep ``solve``: finite state, Energy rising, AEPE falling;
4. a short ``tpu_fast_super`` solve (97x146 lattice) and 30 sweeps of the
   exact-bicubic ``full_mixture`` preset: finite state;
5. the program (every loaded module of this repository) imported nothing
   beyond numpy, scipy, optax, chex, einops, pytest, hypothesis and JAX.

With ``--four`` it runs only the sharded paths on four cards, each against
the single-card result: ``solve`` over a (dp=1, x=2, y=2) GSPMD mesh, and
the shard_map halo sweep on a 2x2 mesh.

The last line of standard output is one JSON object
``{"ok": true, "device": {...}}``; any failed phase exits non-zero without
it. Without a GPU backend the script exits non-zero at once.

    python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SHAPE = (388, 584)   # Middlebury RubberWhale frame size
# Kernel parity vs float64, as max |f32 - f64| / max |f64| per output.
# The kernel runs in float32 (24-bit mantissa, ~6e-8): each of the A*B
# mode terms carries rounding from the exp and the cos/sin rotation
# recurrences, whose phase error grows ~linearly with the degree (up to
# 64), and the sums cancel terms larger than their result. 1e-4 leaves
# about two decimal digits of margin over that budget (A*B*eps ~ 6e-5
# worst case, typically far less) and still fails on any indexing or
# algebra fault, which shows up at O(1).
KERNEL_RTOL = 1e-4
# One full sweep, f32 production path vs f64 XLA path, relative to each
# field's largest update. A float32 sweep departs from float64 by itself:
# the f32 coefficient build (bicubic samples and DCT) and the 1/sigma and
# 1/(1-p^2) factors of the updates amplify its rounding, most at sigma =
# 0.05. So the production path may be 1e-3 off, or twice as far off as the
# same sweep on XLA's f32 path, whichever is larger: the kernels may cost
# no more precision than float32 itself does.
SWEEP_RTOL = 1e-3
SWEEP_VS_XLA32 = 2.0
# Sharded vs single-card energy (f32): only the order of partial sums
# differs.
ENERGY_RTOL = 2e-5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def rel_err(got, want) -> float:
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def problem_inputs(shape=SHAPE, seed=0):
    from gqmap_tpu.config import FlowRange
    from gqmap_tpu.io.synthetic import synthetic_pair

    I1, I2, flow = synthetic_pair(shape, seed=seed)
    fr = FlowRange(float(flow[..., 0].min()), float(flow[..., 0].max()),
                   float(flow[..., 1].min()), float(flow[..., 1].max()))
    return I1, I2, flow, fr


def regimes(state):
    import jax.numpy as jnp

    conv = state._replace(sigmau=jnp.full_like(state.sigmau, 0.05),
                          sigmav=jnp.full_like(state.sigmav, 0.05))
    return {"init": state, "converged": conv}


def to64(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def phase_kernels():
    """Each GPU kernel vs the plain XLA path in float64, both regimes."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gqmap_tpu.config import GQMAPConfig
    from gqmap_tpu.kernels.cosine_gq import cos_mode_sums_pallas
    from gqmap_tpu.kernels.edge_reduced_gq import edge_reduced_grads_pallas
    from gqmap_tpu.models.gqmap import init_state, make_problem
    from gqmap_tpu.ops.cosine import _mode_sums
    from gqmap_tpu.ops.gq import EDGE, finalize, gq_accumulate_diff
    from gqmap_tpu.ops.potentials import make_edge_pot_diff
    from gqmap_tpu.ops.quadrature import build_table_1d

    I1, I2, _, fr = problem_inputs()
    cfg = GQMAPConfig.tpu_fast()
    problem = make_problem(cfg, I1, I2, fr)
    node_k = jax.jit(cos_mode_sums_pallas)
    node_ref = jax.jit(lambda c, *s: _mode_sums(
        c, *s, cfg.cheb_ablock, want_grads=True)[0])

    k1 = 2 * cfg.K + 3
    tab1 = build_table_1d(k1, dtype=np.float64)
    gd = make_edge_pot_diff(cfg.lambdas, cfg.epsn)
    alpha = jnp.asarray([0.5, 0.3, 0.2])
    T = jnp.asarray(0.1)

    def edge_args(st):
        mu = jnp.stack([st.muu, st.muv])
        sg = jnp.stack([st.sigmau, st.sigmav])
        u2e = jnp.stack([jnp.roll(mu, -1, -2), jnp.roll(mu, -1, -1)])
        o2e = jnp.stack([jnp.roll(sg, -1, -2), jnp.roll(sg, -1, -1)])
        return mu, sg, u2e, o2e, st.rou

    edge_k = jax.jit(lambda *e: edge_reduced_grads_pallas(
        *e, alpha.astype(jnp.float32), T.astype(jnp.float32), k1,
        cfg.lambdas, cfg.epsn, EDGE))

    @jax.jit
    def edge_ref(mu, sg, u2e, o2e, rou):
        raw = gq_accumulate_diff(gd, mu[None], u2e, sg[None], o2e, rou, tab1)
        return finalize(raw, alpha.reshape(-1, 1, 1), sg[None], o2e, rou, T,
                        EDGE)

    rng = np.random.default_rng(1)
    worst = 0.0
    for regime, st in regimes(init_state(cfg, fr, I1.shape)).items():
        st = st._replace(
            pn=jnp.asarray(rng.uniform(-0.9, 0.9, st.pn.shape), jnp.float32),
            rou=jnp.asarray(rng.uniform(-0.9, 0.9, st.rou.shape), jnp.float32))
        sargs = (problem.cheb, st.muu, st.muv, st.sigmau, st.sigmav, st.pn)
        got = node_k(*sargs)
        want = node_ref(*to64(sargs))
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        print(f"  node kernel vs f64 [{regime}]: max rel err per sum "
              f"{['%.2e' % e for e in errs]} (tol {KERNEL_RTOL:.0e})")
        worst = max(worst, *errs)
        eargs = edge_args(st)
        got = edge_k(*eargs)
        want = edge_ref(*to64(eargs))
        errs = [rel_err(getattr(got, f), getattr(want, f))
                for f in want._fields]
        print(f"  edge kernel vs f64 [{regime}]: max rel err per field "
              f"{['%.2e' % e for e in errs]} (tol {KERNEL_RTOL:.0e})")
        worst = max(worst, *errs)
    assert worst <= KERNEL_RTOL, f"kernel parity {worst:.3e} > {KERNEL_RTOL}"


def phase_sweep():
    """One production f32 sweep vs the same sweep in f64 on XLA."""
    import dataclasses

    import jax

    from gqmap_tpu.config import GQMAPConfig
    from gqmap_tpu.models.gqmap import init_state, make_problem, make_sweep

    I1, I2, _, fr = problem_inputs()
    cfg = GQMAPConfig.tpu_fast()
    xla = dict(node_kernel="xla", edge_kernel="xla")
    arms = {"prod": cfg, "xla32": dataclasses.replace(cfg, **xla),
            "xla64": dataclasses.replace(cfg, dtype="float64", **xla)}
    problems = {"prod": make_problem(cfg, I1, I2, fr)}
    problems["xla32"] = problems["prod"]
    problems["xla64"] = make_problem(arms["xla64"], I1, I2, fr)
    sweeps = {k: jax.jit(make_sweep(c, I1.shape)) for k, c in arms.items()}
    for regime, st in regimes(init_state(cfg, fr, I1.shape)).items():
        out = {k: sweeps[k](problems[k], to64(st) if k == "xla64" else st)
               for k in arms}
        n64, a64 = out["xla64"]
        errs = {}
        for k in ("prod", "xla32"):
            n, a = out[k]
            errs[k] = {"energy": rel_err(a.energy, a64.energy)}
            for f in ("muu", "muv", "sigmau", "sigmav", "pn", "rou"):
                old = getattr(st, f).astype("float64")
                errs[k][f] = rel_err(getattr(n, f).astype("float64") - old,
                                     getattr(n64, f) - old)
        for k, label in (("prod", "f32 production (kernels)"),
                         ("xla32", "f32 XLA")):
            print(f"  sweep {label} vs f64 XLA [{regime}]: "
                  + ", ".join(f"{f} {v:.2e}" for f, v in errs[k].items()))
        for f, e in errs["prod"].items():
            bound = max(SWEEP_RTOL, SWEEP_VS_XLA32 * errs["xla32"][f])
            assert e <= bound, f"{regime} {f}: {e:.3e} > {bound:.3e}"


def assert_finite(res, what):
    import numpy as np

    for f in res.state._fields:
        v = np.asarray(getattr(res.state, f))
        assert np.isfinite(v).all(), f"{what}: non-finite state leaf {f}"


def phase_solve():
    """900-sweep tpu_fast solve at full width: Energy up, AEPE down."""
    import numpy as np

    from gqmap_tpu import GQMAPConfig, solve

    I1, I2, flow, _ = problem_inputs()
    cfg = GQMAPConfig.tpu_fast(its=900, eval_every=300)
    stamps = {}
    t0 = time.perf_counter()
    res = solve(cfg, I1, I2, gt_flow=flow,
                callback=lambda it, *_: stamps.setdefault(
                    it, time.perf_counter()))
    wall = time.perf_counter() - t0
    assert_finite(res, "tpu_fast solve")
    evals = sorted(stamps)
    aepe = [float(res.AEPE[i - 1]) for i in evals]
    energy = [float(res.Energy[i - 1]) for i in evals]
    ms = (stamps[900] - stamps[300]) / 600 * 1e3
    print(f"  tpu_fast solve {SHAPE[0]}x{SHAPE[1]}: set-up incl. compile "
          f"{stamps[1] - t0:.1f} s, {ms:.3f} ms/sweep (sweeps 300-900, "
          f"eval readouts included), wall {wall:.1f} s")
    print(f"  evals at {evals}: AEPE {['%.4f' % a for a in aepe]}, "
          f"Energy {['%.6e' % e for e in energy]}")
    assert np.isfinite(res.Energy).all(), "non-finite Energy trace"
    assert energy[-1] > energy[0], "Energy did not rise"
    assert aepe[-1] < aepe[0], "AEPE did not fall"
    assert res.best_aepe < 0.5 * aepe[0], "AEPE fell by less than half"


def phase_presets():
    """Short super-lattice solve and exact-bicubic sweeps: finite state."""
    from gqmap_tpu import GQMAPConfig, solve

    I1, I2, flow, _ = problem_inputs()
    for name, cfg in (
        ("tpu_fast_super (97x146 lattice)",
         GQMAPConfig.tpu_fast_super(its=60, eval_every=30)),
        ("full_mixture exact bicubic",
         GQMAPConfig.full_mixture(its=30, eval_every=30)),
    ):
        t0 = time.perf_counter()
        res = solve(cfg, I1, I2, gt_flow=flow)
        assert_finite(res, name)
        print(f"  {name}: {res.iters} sweeps in {time.perf_counter() - t0:.1f} s "
              f"incl. compile, best AEPE {res.best_aepe:.4f}, state finite")


def phase_imports():
    """The program imported nothing outside the allowed packages."""
    import ast

    allowed = set(sys.stdlib_module_names) | {
        "numpy", "scipy", "optax", "chex", "einops", "pytest", "hypothesis",
        "jax", "jaxlib", "gqmap_tpu"}
    mods = [m for name, m in list(sys.modules.items())
            if name.split(".")[0] == "gqmap_tpu" or name == "__main__"]
    used = set()
    for mod in mods:
        path = getattr(mod, "__file__", None)
        if not path or not path.endswith(".py"):
            continue
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                used |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and not node.level:
                used.add(node.module.split(".")[0])
    # optional imports (imageio for PNG output) may be named, not loaded
    bad = sorted(m for m in used - allowed if m in sys.modules)
    assert not bad, f"the program imported modules outside the allowed set: {bad}"
    print(f"  imports: {len(mods)} program modules checked; "
          f"outside the allowed set and never loaded: {sorted(used - allowed)}")


def phase_four():
    """Sharded solve (GSPMD) and halo sweep (shard_map) vs one card."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from gqmap_tpu import GQMAPConfig, solve
    from gqmap_tpu.models.gqmap import init_state, make_problem, make_sweep
    from gqmap_tpu.parallel import make_mesh
    from gqmap_tpu.parallel.halo import make_halo_sweep
    from gqmap_tpu.parallel.sharded import shard_problem

    assert len(jax.devices()) >= 4, f"need 4 devices, have {len(jax.devices())}"
    I1, I2, flow, fr = problem_inputs()
    cfg = GQMAPConfig.tpu_fast(its=20, eval_every=10)
    # the same GSPMD (XLA) path on a one-card mesh: only the partitioning
    # and the order of partial sums differ
    res1 = solve(cfg, I1, I2, gt_flow=flow,
                 mesh=make_mesh(1, devices=jax.devices()[:1]))
    mesh = make_mesh(4, dp=1)
    print(f"  mesh {dict(zip(mesh.axis_names, mesh.devices.shape))}")
    res4 = solve(cfg, I1, I2, gt_flow=flow, mesh=mesh)
    assert_finite(res4, "sharded solve")
    e = rel_err(res4.Energy, res1.Energy)
    print(f"  GSPMD solve on 4 cards vs 1 card: Energy trace max rel err "
          f"{e:.2e} (tol {ENERGY_RTOL:.0e}); best AEPE {res4.best_aepe:.6f} "
          f"vs {res1.best_aepe:.6f}")
    assert e <= ENERGY_RTOL, f"sharded solve energy {e:.3e} > {ENERGY_RTOL}"

    problem = make_problem(cfg, I1, I2, fr)
    st = init_state(cfg, fr, I1.shape)
    ref, ref_aux = jax.jit(make_sweep(cfg, I1.shape))(problem, st)
    xy = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    out, aux = make_halo_sweep(cfg, I1.shape, xy)(shard_problem(problem, xy), st)
    e = rel_err(aux.energy, ref_aux.energy)
    m = rel_err(out.muu, ref.muu)
    print(f"  halo sweep on a 2x2 mesh (kernels per shard) vs 1 card: energy "
          f"rel err {e:.2e} (tol {ENERGY_RTOL:.0e}), muu rel err {m:.2e}")
    assert e <= ENERGY_RTOL, f"halo energy {e:.3e} > {ENERGY_RTOL}"
    assert m <= 1e-5, f"halo muu {m:.3e} > 1e-5"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phases")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_enable_x64", True)  # the float64 references
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU backend, JAX found "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    from gqmap_tpu.utils import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    print(f"card: {card_line()}")
    print(f"device_kind: {dev.device_kind}; jax {jax.__version__}; "
          f"{len(jax.devices())} device(s)")

    phases = [phase_four] if args.four else [
        phase_kernels, phase_sweep, phase_solve, phase_presets, phase_imports]
    failed = []
    for phase in phases:
        t0 = time.perf_counter()
        print(f"[{phase.__name__}] {phase.__doc__}", flush=True)
        status = "ok"
        try:
            phase()
        except Exception:
            traceback.print_exc()
            failed.append(phase.__name__)
            status = "FAILED"
        print(f"[{phase.__name__}] {status} in {time.perf_counter() - t0:.1f} s",
              flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
