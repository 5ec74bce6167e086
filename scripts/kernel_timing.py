"""Time the GPU kernels against XLA's plain paths on the card.

Two levels, both in the two sigma regimes of a solve (``init``: the random
initial state, where the adaptive u-cutoff can engage; ``converged``:
sigma pinned to 0.05, where the zero-exp recurrence is taken):

* end to end: ms/sweep of a ``make_segment_runner`` segment of the
  ``tpu_fast`` preset for every (node, edge) choice of ``xla``/``pallas``;
* isolated: the node term (mode sums) and the edge term alone, for a few
  kernel block shapes;
* where the time goes: a profiler trace of one production segment per
  regime, reduced to device time per kernel name and the device's idle
  share over the segment.

Configurations are timed in interleaved rounds on one card; the median of
the rounds is reported. Each line of output is one JSON record; with
``--out`` they are also appended to a file.

    python scripts/kernel_timing.py --out kernel_timing.jsonl [--trace-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except OSError:
        return "unknown"


def timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0


def interleaved(fns: dict, rounds: int):
    """Median seconds per call of each fn, timed in interleaved rounds."""
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, (fn, args) in fns.items():
            times[k].append(timed(fn, *args))
    return {k: float(np.median(v)) for k, v in times.items()}


def device_breakdown(trace_dir):
    """Kernel time per name, busy time, window and the lines read, from a
    jax trace. Only the GPU planes' stream lines (kernel executions) count:
    module and op-level lines span whole programs."""
    import glob

    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    per_name, spans, lines = {}, [], set()
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            lines.add(line.name)
            for ev in line.events:
                per_name[ev.name] = per_name.get(ev.name, 0.0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = spans[-1][1] - spans[0][0] if spans else 0.0
    return per_name, busy, window, sorted(lines)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--shape", type=int, nargs=2, default=(388, 584))
    ap.add_argument("--sweeps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace-dir", default=None,
                    help="keep the profiler traces here (default: a "
                         "temporary directory)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from gqmap_tpu.config import FlowRange, GQMAPConfig
    from gqmap_tpu.io.synthetic import synthetic_pair
    from gqmap_tpu.kernels.cosine_gq import cos_mode_sums_pallas
    from gqmap_tpu.kernels.edge_reduced_gq import edge_reduced_grads_pallas
    from gqmap_tpu.models.gqmap import init_state, make_problem, make_segment_runner
    from gqmap_tpu.ops.cosine import _mode_sums
    from gqmap_tpu.ops.gq import EDGE, finalize, gq_accumulate_diff
    from gqmap_tpu.ops.potentials import make_edge_pot_diff
    from gqmap_tpu.ops.quadrature import build_table_1d
    from gqmap_tpu.utils import enable_compile_cache

    if jax.default_backend() != "gpu":
        sys.exit(f"needs a GPU backend, found {jax.default_backend()!r}")
    enable_compile_cache()
    dev = jax.devices()[0]
    meta = dict(card=card(), device_kind=dev.device_kind, jax=jax.__version__,
                shape=list(args.shape))
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        rec = {**meta, **rec}
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    I1, I2, flow = synthetic_pair(tuple(args.shape), seed=0)
    fr = FlowRange(float(flow[..., 0].min()), float(flow[..., 0].max()),
                   float(flow[..., 1].min()), float(flow[..., 1].max()))
    base = GQMAPConfig.tpu_fast(eval_every=args.sweeps, tor=0.0)
    problem = make_problem(base, I1, I2, fr)
    s_init = init_state(base, fr, I1.shape)
    s_conv = s_init._replace(sigmau=jnp.full_like(s_init.sigmau, 0.05),
                             sigmav=jnp.full_like(s_init.sigmav, 0.05))
    regimes = {"init": s_init, "converged": s_conv}
    n_sites = I1.size

    # --- isolated node term -------------------------------------------
    cos = problem.cheb
    fns = {"xla": jax.jit(lambda c, *s: _mode_sums(
        c, *s, base.cheb_ablock, want_grads=True)[0])}
    for block, warps in ((64, 2), (128, 4), (256, 4), (256, 8)):
        fns[f"pallas_b{block}_w{warps}"] = jax.jit(
            lambda c, *s, b=block, w=warps: cos_mode_sums_pallas(
                c, *s, block=b, num_warps=w))
    for regime, st in regimes.items():
        sargs = (cos, st.muu, st.muv, st.sigmau, st.sigmav, st.pn)
        want = fns["xla"](*sargs)
        for k, fn in fns.items():
            got = fn(*sargs)
            err = max(float(jnp.max(jnp.abs(g - w)) / jnp.max(jnp.abs(w)))
                      for g, w in zip(got, want))
            emit(dict(kind="node_parity_vs_xla_f32", regime=regime,
                      impl=k, max_rel_err=err))
        timings = interleaved({k: (fn, sargs) for k, fn in fns.items()},
                              args.rounds)
        for k, sec in timings.items():
            emit(dict(kind="node_term", regime=regime, impl=k,
                      ms=sec * 1e3))

    # --- isolated edge term -------------------------------------------
    k1 = 2 * base.K + 3
    tab1 = build_table_1d(k1, dtype=np.float32)
    gd = make_edge_pot_diff(base.lambdas, base.epsn)
    alpha = jnp.full((base.L,), 1.0 / base.L, jnp.float32)
    T = jnp.asarray(0.0, jnp.float32)

    def edge_inputs(st):
        mu = jnp.stack([st.muu, st.muv])
        sg = jnp.stack([st.sigmau, st.sigmav])
        u2e = jnp.stack([jnp.roll(mu, -1, -2), jnp.roll(mu, -1, -1)])
        o2e = jnp.stack([jnp.roll(sg, -1, -2), jnp.roll(sg, -1, -1)])
        return mu, sg, u2e, o2e, st.rou

    @jax.jit
    def edge_xla(mu, sg, u2e, o2e, rou):
        raw = gq_accumulate_diff(gd, mu[None], u2e, sg[None], o2e, rou, tab1)
        return finalize(raw, alpha.reshape(-1, 1, 1), sg[None], o2e, rou, T,
                        EDGE)

    efns = {"xla": edge_xla}
    for block, warps in ((128, 4), (256, 4), (512, 8)):
        efns[f"pallas_b{block}_w{warps}"] = jax.jit(
            lambda *e, b=block, w=warps: edge_reduced_grads_pallas(
                *e, alpha, T, k1, base.lambdas, base.epsn, EDGE,
                block=b, num_warps=w))
    for regime, st in regimes.items():
        eargs = edge_inputs(st)
        want = edge_xla(*eargs)
        for k, fn in efns.items():
            got = fn(*eargs)
            err = max(float(jnp.max(jnp.abs(g - w)) / jnp.max(jnp.abs(w)))
                      for g, w in zip(got, want))
            emit(dict(kind="edge_parity_vs_xla_f32", regime=regime,
                      impl=k, max_rel_err=err))
        timings = interleaved({k: (fn, eargs) for k, fn in efns.items()},
                              args.rounds)
        for k, sec in timings.items():
            emit(dict(kind="edge_term", regime=regime, impl=k, ms=sec * 1e3))

    # --- end to end: one segment of the production path ----------------
    segs = {}
    for node in ("xla", "pallas"):
        for edge in ("xla", "pallas"):
            cfg = GQMAPConfig.tpu_fast(eval_every=args.sweeps, tor=0.0,
                                       node_kernel=node, edge_kernel=edge)
            segs[(node, edge)] = make_segment_runner(cfg, I1.shape)
    for regime, st in regimes.items():
        for (node, edge), seg in segs.items():
            t0 = time.perf_counter()
            jax.block_until_ready(seg(problem, st, 2))
            emit(dict(kind="segment_warmup", regime=regime, node=node,
                      edge=edge, s=time.perf_counter() - t0))
        timings = interleaved(
            {k: (seg, (problem, st, args.sweeps)) for k, seg in segs.items()},
            args.rounds)
        for (node, edge), sec in timings.items():
            ms = sec * 1e3 / args.sweeps
            emit(dict(kind="segment", regime=regime, node=node, edge=edge,
                      sweeps=args.sweeps, ms_per_sweep=ms,
                      mpix_sweeps_per_s=n_sites / (ms * 1e3)))

    # --- where the time goes: one traced production segment per regime --
    seg = make_segment_runner(base, I1.shape)
    trace_root = args.trace_dir or tempfile.mkdtemp(prefix="kernel_trace_")
    for regime, st in regimes.items():
        jax.block_until_ready(seg(problem, st, args.sweeps))
        tdir = os.path.join(trace_root, regime)
        with jax.profiler.trace(tdir):
            jax.block_until_ready(seg(problem, st, args.sweeps))
        per_name, busy, window, lines = device_breakdown(tdir)
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
        emit(dict(kind="trace_segment", regime=regime, sweeps=args.sweeps,
                  lines=lines, window_ms=window / 1e6,
                  device_busy_ms_per_sweep=busy / 1e6 / args.sweeps,
                  idle_share=1.0 - busy / window if window else None,
                  top_ms_per_sweep={k: v / 1e6 / args.sweeps for k, v in top}))


if __name__ == "__main__":
    main()
