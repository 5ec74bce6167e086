"""f32 kernel conditioning vs the f64 golden path.

The production kernels run f32; the reference runs f64, and the
Stein-gradient scale factors contain 1/(1-p^2) terms that blow up as |rho|
approaches the corr_tor clamp (``gqmap_gpu_mixture.m:92-93`` — the factor
the clamps guard). SURVEY §7.2(3) asks for a *measured* error bound for
the production kernel near the clamps. This script records one:

1. Warm the flagship solver (RubberWhale @0.25, tpu_fast) for 2000 sweeps
   on the default backend to a realistic converged state.
2. Build two probe states from it: the warmed state as-is ("converged"),
   and an adversarial copy with sigma forced to the 0.01 floor and |rho|
   pushed to corr_tor - 1e-7 ("clamped" — the ill-conditioned corner,
   1/(1-p^2) ~ 5e4).
3. For each probe, run THREE arms from the SAME state:
     * f32 / production path (node_kernel="auto": the GPU kernels on a
       GPU), this process's backend;
     * f32 / XLA (node_kernel="xla") in a JAX_PLATFORMS=cpu subprocess —
       isolates precision from kernel implementation;
     * f64 / XLA golden in the same CPU subprocess.
   Each arm records the one-sweep parameter delta (step x gradient: the
   direct gradient-deviation measure) and the 300-sweep drift.
4. Write max/mean deviations (f32-pallas vs f64 and f32-xla vs f64) to
   results/f32_conditioning.json; tests/test_f32_conditioning.py asserts
   the recorded bound stays put.

Units: mu deviations are PIXELS of flow; sigma/rho deviations are
absolute in parameter space.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUTJ = os.path.join(REPO, "results", "f32_conditioning.json")
TMP = os.path.join(REPO, "results", "_f32cond")

N_SWEEPS = int(os.environ.get("F32COND_SWEEPS", "300"))  # env: smoke-test knob
WARM = int(os.environ.get("F32COND_WARM", "2000"))
FIELDS = ("muu", "muv", "sigmau", "sigmav", "pn", "rou")


def build_cfg(dtype, kernel):
    from gqmap_tpu.config import GQMAPConfig

    return GQMAPConfig.tpu_fast(
        dtype=dtype, cheb_p=96, cheb_q=16, node_kernel=kernel,
        edge_kernel=kernel if kernel == "xla" else "auto",
        eval_every=10**9, tor=0.0,
    )


def load_problem():
    from gqmap_tpu.io.dataset import load_sequence
    from gqmap_tpu.ops.flowviz import flow_to_color
    from gqmap_tpu.config import FlowRange

    seq = load_sequence("RubberWhale", scale=0.25)
    fc = flow_to_color(seq.gt_flow)
    fr = FlowRange(fc.minu, fc.maxu, fc.minv, fc.maxv)
    return seq.img1, seq.img2, fr


def state_to_npz(path, st):
    np.savez(path, **{k: np.asarray(getattr(st, k), np.float64)
                      for k in FIELDS},
             w=np.asarray(st.w, np.float64),
             temperature=float(st.temperature), it=int(st.it))


def state_from_npz(path, cfg, fr, shape):
    from gqmap_tpu.models.gqmap import init_state
    import jax.numpy as jnp

    d = np.load(path)
    st = init_state(cfg, fr, shape)
    dt = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    return st._replace(
        **{k: jnp.asarray(d[k], dt) for k in FIELDS},
        w=jnp.asarray(d["w"], dt),
        temperature=jnp.asarray(float(d["temperature"]), dt),
        it=jnp.asarray(int(d["it"]), jnp.int32),
    )


def run_arm(tag, cfg, probe_path, out_path):
    """One-sweep delta + N-sweep drift from the shared probe state."""
    import jax

    from gqmap_tpu.models.gqmap import make_problem, make_sweep

    I1, I2, fr = load_problem()
    problem = make_problem(cfg, I1, I2, fr)
    st0 = state_from_npz(probe_path, cfg, fr, I1.shape)
    sweep = jax.jit(make_sweep(cfg, I1.shape))
    s1, _ = sweep(problem, st0)
    float(s1.muu.sum())  # sync
    out = {f"delta1_{k}": np.asarray(getattr(s1, k), np.float64)
           - np.asarray(getattr(st0, k), np.float64) for k in FIELDS}
    s = s1
    for _ in range(N_SWEEPS - 1):
        s, _ = sweep(problem, s)
    float(s.muu.sum())
    for k in FIELDS:
        out[f"state_{k}"] = np.asarray(getattr(s, k), np.float64)
    np.savez(out_path, **out)
    print(f"[f32cond] arm {tag} done -> {out_path}", flush=True)


def compare(a_path, b_path):
    """max/mean abs deviation of arm a vs arm b, per field group."""
    a, b = np.load(a_path), np.load(b_path)
    out = {}
    for pref, label in (("delta1_", "grad"), ("state_", "drift")):
        for k in FIELDS:
            d = np.abs(a[pref + k] - b[pref + k])
            out[f"{label}_{k}_max"] = float(d.max())
            out[f"{label}_{k}_mean"] = float(d.mean())
        mu = np.sqrt((a[pref + "muu"] - b[pref + "muu"]) ** 2
                     + (a[pref + "muv"] - b[pref + "muv"]) ** 2)
        out[f"{label}_flow_epe_max"] = float(mu.max())
        out[f"{label}_flow_epe_mean"] = float(mu.mean())
    return out


def main_child(which):
    """CPU subprocess: f32-xla + f64-xla arms for one probe."""
    for dtype, kernel, tag in (("float32", "xla", "f32xla"),
                               ("float64", "xla", "f64")):
        cfg = build_cfg(dtype, kernel)
        run_arm(f"{tag}/{which}", cfg, os.path.join(TMP, f"probe_{which}.npz"),
                os.path.join(TMP, f"{tag}_{which}.npz"))


def main():
    from gqmap_tpu.utils import enable_compile_cache

    enable_compile_cache()
    os.makedirs(TMP, exist_ok=True)
    import jax
    import jax.numpy as jnp

    from gqmap_tpu.models.gqmap import init_state, make_problem, make_segment_runner

    t0 = time.time()
    # 1. warm to a realistic converged-regime state on the fast backend
    cfg = build_cfg("float32", "auto")
    I1, I2, fr = load_problem()
    problem = make_problem(cfg, I1, I2, fr)
    st = init_state(cfg, fr, I1.shape)
    seg = make_segment_runner(cfg, I1.shape)
    st, n, eb, *_ = seg(problem, st, WARM)
    float(eb[0])

    # 2. probes
    state_to_npz(os.path.join(TMP, "probe_converged.npz"), st)
    tor = cfg.corr_tor - 1e-7
    clamped = st._replace(
        sigmau=jnp.full_like(st.sigmau, cfg.sigma_min),
        sigmav=jnp.full_like(st.sigmav, cfg.sigma_min),
        pn=jnp.sign(st.pn) * tor,
        rou=jnp.sign(st.rou) * tor,
    )
    state_to_npz(os.path.join(TMP, "probe_clamped.npz"), clamped)

    results = {"n_sweeps": N_SWEEPS, "workload": "RubberWhale@0.25 tpu_fast 96x16",
               "warm_sweeps": WARM, "probes": {}}
    for which in ("converged", "clamped"):
        probe = os.path.join(TMP, f"probe_{which}.npz")
        # 3a. production arm (this process's backend)
        run_arm(f"f32pallas/{which}", build_cfg("float32", "auto"), probe,
                os.path.join(TMP, f"f32pallas_{which}.npz"))
        # 3b. CPU subprocess: f32-xla + f64 golden (the parent holds the
        # GPU; the child stays off it).
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env["JAX_ENABLE_X64"] = "1"
        env["PYTHONPATH"] = REPO
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "child", which], env=env, cwd=REPO).returncode
        if rc != 0:
            sys.exit(rc)
        results["probes"][which] = {
            "f32_pallas_vs_f64": compare(
                os.path.join(TMP, f"f32pallas_{which}.npz"),
                os.path.join(TMP, f"f64_{which}.npz")),
            "f32_xla_vs_f64": compare(
                os.path.join(TMP, f"f32xla_{which}.npz"),
                os.path.join(TMP, f"f64_{which}.npz")),
        }
    results["wall_s"] = round(time.time() - t0, 1)
    results["device"] = str(jax.devices()[0])
    with open(OUTJ, "w") as f:
        json.dump(results, f, indent=1)
    print(f"[f32cond] wrote {OUTJ} ({results['wall_s']} s)", flush=True)
    for which, r in results["probes"].items():
        pv = r["f32_pallas_vs_f64"]
        print(f"  {which}: 1-sweep grad EPE max {pv['grad_flow_epe_max']:.3e} "
              f"mean {pv['grad_flow_epe_mean']:.3e}; {N_SWEEPS}-sweep drift "
              f"EPE max {pv['drift_flow_epe_max']:.3e} "
              f"mean {pv['drift_flow_epe_mean']:.3e}", flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "child":
        main_child(sys.argv[2])
    else:
        main()
