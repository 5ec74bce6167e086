"""Command-line interface (the reference's L5 driver scripts as commands).

Subcommands:

* ``run``   — solve one sequence (== ``optical_flow.m`` / ``optical_flowSuper.m``)
* ``suite`` — run a preset over a list of sequences, print the AEPE table
* ``ctf``   — coarse-to-fine pyramid (== ``legacy/optical_flow_ctf.m``)
* ``sweep`` — lambda_s grid search (== ``legacy/LearnRatio.m``)
* ``bench`` — sweep-throughput microbenchmark (one JSON line)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from ..config import GQMAPConfig
from ..io.dataset import crop_to_multiple, load_sequence

PRESETS = {
    "full_mixture": GQMAPConfig.full_mixture,
    "super_entropy": GQMAPConfig.super_entropy,
    "single_gaussian": GQMAPConfig.single_gaussian,
    "tpu_fast": GQMAPConfig.tpu_fast,
    "tpu_fast_super": GQMAPConfig.tpu_fast_super,
    "legacy_v1": GQMAPConfig.legacy_v1,
    "legacy_v2": GQMAPConfig.legacy_v2,
    "legacy_v3": GQMAPConfig.legacy_v3,
    "blockmatch_v2": GQMAPConfig.blockmatch_v2,
    "ctf_level": GQMAPConfig.ctf_level,
}


def _cfg_from_args(args) -> GQMAPConfig:
    cfg = PRESETS[args.preset]()
    over = {}
    for field in ("K", "L", "its", "lambdas", "lambdad", "temperature", "eval_every",
                  "quad_chunk", "dtype", "seed", "data_term", "window_rg",
                  "cheb_p", "cheb_q", "sweep_order"):
        v = getattr(args, field.lower(), None)
        if v is not None:
            over[field] = v
    return dataclasses.replace(cfg, **over) if over else cfg


def _add_common(p):
    p.add_argument("--preset", default="full_mixture", choices=sorted(PRESETS))
    p.add_argument("--its", type=int, default=None)
    p.add_argument("--k", dest="k", type=int, default=None)
    p.add_argument("--l", dest="l", type=int, default=None)
    p.add_argument("--lambdas", type=float, default=None)
    p.add_argument("--lambdad", type=float, default=None)
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--eval-every", dest="eval_every", type=int, default=None)
    p.add_argument("--quad-chunk", dest="quad_chunk", type=int, default=None)
    p.add_argument("--dtype", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--data-term", dest="data_term", default=None)
    p.add_argument("--window-rg", dest="window_rg", type=int, default=None,
                   help="overlapping data-cost window half-size (legacy/gqmap_cpuV2.m)")
    p.add_argument("--cheb-p", dest="cheb_p", type=int, default=None,
                   help="spectral u-degree for chebyshev/cosine data terms")
    p.add_argument("--sweep-order", dest="sweep_order", default=None,
                   choices=["jacobi", "redblack"],
                   help="update order: synchronous Jacobi (reference) or "
                        "checkerboard Gauss-Seidel half-steps")
    p.add_argument("--cheb-q", dest="cheb_q", type=int, default=None,
                   help="spectral v-degree for chebyshev/cosine data terms")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--preprocessed", action="store_true")
    p.add_argument("--st-preprocess", action="store_true",
                   help="on-the-fly structure-texture preprocessing (any sequence)")
    p.add_argument("--out", default=None, help="directory for PNG/metrics output")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--devices", type=int, default=None,
                   help="shard the lattice over up to N devices (a (dp, x, y) "
                        "jax.sharding.Mesh; GSPMD inserts halos/psums). "
                        "Default: single device")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel axis size of the mesh (devices must "
                        "be divisible by it)")


def _mesh_and_crop(args, cfg):
    """The (dp, x, y) mesh requested by --devices/--dp plus the (km, kn)
    crop unit that makes the solver lattice divide it (GSPMD requires even
    division; a near-square factorization is chosen and the ragged edge
    cropped, instead of silently dropping devices on awkward shapes)."""
    if getattr(args, "devices", None) is None:
        return None, cfg.patch
    from ..parallel import factor_2d, make_mesh

    x, y = factor_2d(args.devices // args.dp)
    mesh = make_mesh(args.devices, dp=args.dp)
    if not args.quiet:
        print(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))} "
              f"over {mesh.devices.size} device(s)")
    return mesh, (cfg.patch * x, cfg.patch * y)


def _fix_kl(args):
    if getattr(args, "k", None) is not None:
        args.K = args.k
    if getattr(args, "l", None) is not None:
        args.L = args.l


def cmd_run(args):
    from ..models.gqmap import solve

    _fix_kl(args)
    cfg = _cfg_from_args(args)
    mesh, crop = _mesh_and_crop(args, cfg)
    seq = load_sequence(args.seq, scale=args.scale, preprocessed=args.preprocessed,
                        st_preprocess=args.st_preprocess)
    seq = crop_to_multiple(seq, crop)
    cb = None
    if args.out:
        from ..evals.metrics import MetricsLogger

        ml = MetricsLogger(f"{args.out}/metrics.jsonl",
                           run_meta=dict(seq=args.seq, cfg=dataclasses.asdict(cfg)))
        cb = ml.solver_callback(seq.img1.size)
    init_flow = None
    if args.init == "blockmatch":
        # the legacy/optical_flow_temp.m experiment: cost-volume block
        # matching -> integer flow init -> solver -> .flo export (via --out)
        from ..models.blockmatch import block_matching_init

        w = int(6 * args.scale) + 1 if args.bm_window is None else args.bm_window
        init_flow = block_matching_init(seq.img1, seq.img2, U=w, V=w)
        if cfg.patch > 1:
            init_flow = init_flow[:: cfg.patch, :: cfg.patch]
    res = solve(
        cfg, seq.img1, seq.img2, gt_flow=seq.gt_flow,
        out_dir=args.out, verbose=not args.quiet, callback=cb,
        checkpoint_path=args.checkpoint, checkpoint_every=args.checkpoint_every,
        resume=args.resume, init_flow=init_flow, reset_at=args.reset_at,
        mesh=mesh,
    )
    print(json.dumps({"seq": args.seq, "best_aepe": res.best_aepe, "iters": res.iters}))
    if args.out:
        from ..io.flo import write_flo

        np.savez(f"{args.out}/{args.seq}.npz", mu=res.mu, sigma=res.sigma,
                 alpha=res.alpha, AEPE=res.AEPE, Energy=res.Energy, logP=res.logP,
                 map=res.map)
        write_flo(f"{args.out}/{args.seq}.flo", res.map.astype(np.float32))


def cmd_suite(args):
    from ..models.gqmap import solve

    _fix_kl(args)
    cfg = _cfg_from_args(args)
    mesh, crop = _mesh_and_crop(args, cfg)
    results = {}
    for name in args.seqs.split(","):
        seq = crop_to_multiple(load_sequence(name.strip(), scale=args.scale), crop)
        res = solve(cfg, seq.img1, seq.img2, gt_flow=seq.gt_flow,
                    verbose=not args.quiet, mesh=mesh)
        results[name] = res.best_aepe
        print(f"{name}: best AEPE = {res.best_aepe:.4f}")
    avg = float(np.mean(list(results.values())))
    print(json.dumps({"per_seq": results, "avg_aepe": avg}))


def cmd_ctf(args):
    from ..models.ctf import solve_coarse_to_fine

    _fix_kl(args)
    cfg = _cfg_from_args(args)
    seq = load_sequence(args.seq, scale=args.scale)
    res = solve_coarse_to_fine(cfg, seq.img1, seq.img2, seq.gt_flow,
                               verbose=not args.quiet,
                               level_init=args.level_init)
    print(json.dumps({"seq": args.seq, "aepe": res.aepe,
                      "level_init": args.level_init}))


def cmd_sweep(args):
    from ..models.param_sweep import sweep_lambdas

    _fix_kl(args)
    cfg = _cfg_from_args(args)
    seq = crop_to_multiple(load_sequence(args.seq, scale=args.scale), cfg.patch)
    lo, hi, n = args.range
    res = sweep_lambdas(cfg, seq.img1, seq.img2, seq.gt_flow,
                        lambdas=np.linspace(lo, hi, int(n)),
                        log_path=args.log, verbose=not args.quiet)
    print(res.summary())


def cmd_bench(args):
    import subprocess

    # The benchmark runs in a child process, and this parent must never
    # initialise a JAX backend: a JAX process reserves most of a GPU's
    # memory when it first touches the device, so a second one on the same
    # card would fail for want of memory.
    out = subprocess.run([sys.executable, "bench.py"], capture_output=True, text=True)
    sys.stdout.write(out.stdout)
    sys.exit(out.returncode)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gqmap", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run");   _add_common(p); p.add_argument("--seq", required=True)
    p.add_argument("--init", choices=["random", "blockmatch"], default="random",
                   help="mean init: random (reference default) or block-matching "
                        "cost volume (legacy/optical_flow_temp.m)")
    p.add_argument("--bm-window", dest="bm_window", type=int, default=None,
                   help="block-matching search half-window (default floor(6*scale)+1)")
    p.add_argument("--reset-at", dest="reset_at", type=int, default=None,
                   help="apply the reset_para hook after N sweeps (legacy/gqmap_gpuV2.m:54-62)")
    p.set_defaults(fn=cmd_run)
    p = sub.add_parser("suite"); _add_common(p); p.add_argument("--seqs", required=True); p.set_defaults(fn=cmd_suite)
    p = sub.add_parser("ctf");   _add_common(p); p.add_argument("--seq", required=True)
    p.add_argument("--level-init", dest="level_init", default="zero",
                   choices=["zero", "random"],
                   help="per-level mean init. zero (default) seeds each "
                        "level's RESIDUAL solve at zero flow — the r04 fix "
                        "for per-level error compounding. random reproduces "
                        "the reference exactly (legacy/gqmap_ctf.m inherits "
                        "gpuV2's full-box random init; measured to diverge "
                        "on stereo-scale pairs — BASELINE.md)")
    p.set_defaults(fn=cmd_ctf)
    p = sub.add_parser("sweep"); _add_common(p); p.add_argument("--seq", required=True)
    p.add_argument("--range", nargs=3, type=float, default=(0.300001, 1.0, 12))
    p.add_argument("--log", default=None); p.set_defaults(fn=cmd_sweep)
    p = sub.add_parser("bench"); p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    from ..utils import enable_compile_cache

    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
