"""The reference's two live benchmark suites, run to completion (30000 its).

Reproduces the exact workloads of the reference's driver scripts on the
flagship (cosine) path, plus an exact-vs-spectral A/B on a real
sequence:

* stage A — ``optical_flow.m:3,16-27``: full-res L=3 mixture, K=9, T=0,
  30000 its on Teddy + Cones.
* stage B — ``optical_flowSuper.m:3,19-34``: quarter-res super lattice +
  entropy annealing (K=11, lambda_s=16, T=0.2, drate=0.75, 30000 its) on
  Venus, Hydrangea, Urban2, Urban3, Grove3.
* stage C — data-term A/B at matched iterations/seed on RubberWhale @0.25:
  exact bicubic vs nearest vs chebyshev vs cosine.

Cosine degrees are sized from the per-sequence GT displacement box
(Teddy/Cones: 55 px of u-range -> A=192; Urban3: 21 px of v-range -> B=48).
Results: per-run JSONL + npz traces under results/campaign/.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "results", "campaign")


def done_runs():
    """(tag, seq, scale, seed) keys already recorded, for resumable
    campaigns. Scale is part of the key (ADVICE r04: re-running a tag/seq
    at a different scale must not be skipped as already done)."""
    done = set()
    path = os.path.join(OUT, "campaign.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["tag"], r["seq"], float(r.get("scale", 1.0)),
                              r.get("seed", 0)))
                except (json.JSONDecodeError, KeyError):
                    continue
    return done


def run_one(tag, cfg, seq_name, scale=1.0, seed=0, log=None,
            preprocessed=False, init_flow=None):
    from gqmap_tpu.io.dataset import crop_to_multiple, load_sequence
    from gqmap_tpu.models.gqmap import solve

    its = int(os.environ.get("GQMAP_CAMPAIGN_ITS", "0"))
    if its:  # smoke-test override; tag marked so real runs aren't skipped
        cfg = dataclasses.replace(cfg, its=its, eval_every=min(cfg.eval_every, its))
        tag = f"{tag}-smoke{its}"

    force = os.environ.get("GQMAP_CAMPAIGN_FORCE", "") == "1"
    if not force and (tag, seq_name, float(scale), seed) in done_runs():
        print(f"skip {tag} {seq_name} scale={scale} seed={seed}: "
              "already in campaign.jsonl", flush=True)
        return None
    os.makedirs(OUT, exist_ok=True)
    seq = crop_to_multiple(
        load_sequence(seq_name, scale=scale, preprocessed=preprocessed),
        cfg.patch,
    )
    fl = init_flow(seq) if callable(init_flow) else init_flow
    t0 = time.time()
    res = solve(cfg, seq.img1, seq.img2, gt_flow=seq.gt_flow, seed=seed,
                init_flow=fl, verbose=False)
    wall = time.time() - t0
    evals = np.where(np.isfinite(res.AEPE))[0]
    rec = dict(
        tag=tag, seq=seq_name, scale=scale, seed=seed,
        best_aepe=float(res.best_aepe),
        final_aepe=float(res.AEPE[evals[-1]]) if evals.size else None,
        best_at=int(evals[np.nanargmin(res.AEPE[evals])]) + 1 if evals.size else None,
        iters=int(res.iters), wall_s=round(wall, 1),
        ms_per_sweep=round(wall / max(res.iters, 1) * 1e3, 2),
        K=cfg.K, L=cfg.L, data_term=cfg.data_term, patch=cfg.patch,
        cheb_p=cfg.cheb_p, cheb_q=cfg.cheb_q,
        lambdas=cfg.lambdas, temperature=cfg.temperature,
    )
    # scale+seed in the trace filename: multi-seed / multi-scale runs of the
    # same tag must not overwrite each other's traces (ADVICE r04)
    suffix = "" if (scale == 1.0 and seed == 0) else f"_s{scale}_seed{seed}"
    np.savez(os.path.join(OUT, f"{tag}_{seq_name}{suffix}.npz"),
             AEPE=res.AEPE, Energy=res.Energy, logP=res.logP, map=res.map,
             alpha=res.alpha)
    line = json.dumps(rec)
    print(line, flush=True)
    with open(os.path.join(OUT, "campaign.jsonl"), "a") as f:
        f.write(line + "\n")
    return rec


def main(stages=("A", "B", "C")):
    from gqmap_tpu.config import GQMAPConfig
    from gqmap_tpu.utils import enable_compile_cache

    enable_compile_cache()
    results = []

    if "A" in stages:
        # optical_flow.m flagship: Teddy + Cones, full res, 30000 its.
        # u-range ~55 px -> A=192 u-modes (~0.3 px/half-wave); v-range ~0.
        for seq in ("Teddy", "Cones"):
            cfg = GQMAPConfig.tpu_fast(dtype="float32", cheb_p=192, cheb_q=12)
            results.append(run_one("full_cosine", cfg, seq))

    if "B" in stages:
        # optical_flowSuper.m: 5 sequences, super lattice + entropy.
        # Urban3 v-range ~21 px -> B=48 v-modes.
        for seq in ("Venus", "Hydrangea", "Urban2", "Urban3", "Grove3"):
            cfg = GQMAPConfig.tpu_fast_super(dtype="float32", cheb_p=96, cheb_q=48)
            results.append(run_one("super_cosine", cfg, seq))

    if "C" in stages:
        # exact-vs-spectral A/B: same sequence, seed, iterations.
        # Q=16 for both spectral terms (matched A/B); cheb_ablock=4 halves
        # the chebyshev scan body (it python-unrolls a_block*Q mode bodies
        # per scan step).
        base = dict(dtype="float32", its=2000, eval_every=100)
        for term, extra in (
            ("bicubic", dict(quad_chunk=27)),
            ("nearest", dict(quad_chunk=27, rfc=5)),
            ("chebyshev", dict(cheb_p=96, cheb_q=16, quad_chunk=27, cheb_ablock=4)),
            ("cosine", dict(cheb_p=96, cheb_q=16)),
        ):
            cfg = GQMAPConfig.full_mixture(data_term=term, **base, **extra)
            if term in ("chebyshev", "cosine"):
                cfg = dataclasses.replace(cfg, edge_quad="reduced")
            results.append(run_one(f"ab_{term}", cfg, "RubberWhale", scale=0.25))

    print("=== campaign summary ===")
    for r in results:
        if r is None:
            continue
        print(f"{r['tag']:14s} {r['seq']:10s} best AEPE {r['best_aepe']:.4f} "
              f"@{r['best_at']} ({r['ms_per_sweep']} ms/sweep)")


if __name__ == "__main__":
    main(tuple(sys.argv[1].split(",")) if len(sys.argv) > 1 else ("A", "B", "C"))
