"""Run configuration for the GQMAP engine, with the reference presets.

The reference scatters its hyperparameters across driver scripts and solver
constants (``optical_flow.m:16-23``, ``optical_flowSuper.m:19-26``, step
schedules at ``gqmap_gpu_mixture.m:27`` / ``gqmap_gpuSuper_mix_entropy.m:26``,
clamps at ``gqmap_gpu_mixture.m:41-46``). Here everything lives in one
frozen dataclass with per-variant presets, as SURVEY.md section 5 calls for.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

__all__ = ["GQMAPConfig", "FlowRange"]


class FlowRange(NamedTuple):
    """GT-derived clamp/init ranges injected by ``flowToColor_mex``
    (``optical_flow.m:12-13``)."""

    minu: float
    maxu: float
    minv: float
    maxv: float


@dataclasses.dataclass(frozen=True)
class GQMAPConfig:
    # --- model ---
    K: int = 9                    # Gauss-Hermite order (K^2-point 2-D rule)
    L: int = 3                    # mixture components
    epsn: float = 1e-6            # Charbonnier epsilon (0.001^2)
    lambdad: float = 1.0          # data weight
    lambdas: float = 5.0          # smoothness weight
    patch: int = 1                # flow node owns patch x patch image pixels (super: 4)
    data_term: str = "bicubic"    # "bicubic" | "nearest" (legacy I2_cont lookup)
                                  # | "chebyshev" (gather-free spectral term —
                                  #   VALIDATION-ONLY: it needs K^2
                                  #   quadrature where cosine is closed-form,
                                  #   and the matched A/B shows cosine also
                                  #   more accurate (campaign ab_* rows). Kept as an
                                  #   independent spectral cross-check of the
                                  #   cosine path, not an operating mode.)
                                  # | "cosine" (closed-form spectral term: the
                                  #   Gaussian expectation of every mode is the
                                  #   characteristic function — no node
                                  #   quadrature at all, exact gradients;
                                  #   degrees/margin shared with cheb_p/q/margin)
    rfc: int = 6                  # upsample factor exponent for data_term="nearest"
    bicubic_pack: bool = True     # route the 16-tap bicubic sampler through the
                                  # complex-packed gather (8 complex64 taps
                                  # instead of 16 f32 — ops/interp.py
                                  # sample_bicubic(pack_pairs=True)): half the
                                  # gather index count of the exact data term.
                                  # Values identical up to float associativity
                                  # (parity-pinned in tests/test_interp.py);
                                  # f64 golden runs fall back to the unpacked
                                  # path automatically.
    cheb_p: int = 96              # u-degree of the spectral data term
    cheb_q: int = 32              # v-degree
    cheb_margin: float = 2.0      # displacement-box margin beyond the mu range
    cheb_ablock: int = 8          # u-degrees per scan block at evaluation
    node_kernel: str = "auto"     # cosine-term evaluator: "xla" (lax.scan mode
                                  # loop), "pallas" (fused GPU kernel,
                                  # kernels/cosine_gq.py), "auto" (pallas on a
                                  # GPU unless GSPMD-sharded — models/gqmap.py
                                  # use_kernel)
    window_rg: int = 0            # overlapping data-cost window half-size: the
                                  # node potential is the MEAN Charbonnier cost
                                  # over the (2rg+1)^2 pixel window, displacement
                                  # shared across the window (legacy/
                                  # gqmap_cpuV2.m:29-33, gqmap_cpuV3.m:30-32);
                                  # composes with bicubic/nearest directly and
                                  # with the spectral terms via a box-filtered
                                  # coefficient surface. Mutually exclusive
                                  # with patch > 1.
    quad_var: float = 1.0         # variance of the quadratic node prior (legacy v1)
    edge_kind: str = "charbonnier"  # or "truncquad" (legacy/gqmap_cpu.m:43)
    edge_quad: str = "tensor"     # "tensor": K^2-point 2-D rule (reference
                                  # semantics); "reduced": exact 1-D collapse
                                  # of the difference potential
                                  # (ops/gq.gq_accumulate_diff) — ~K x fewer evals
    edge_quad_k: int = 0          # 1-D order for edge_quad="reduced";
                                  # 0 = auto (2K+3: beats the tensor rule's
                                  # effective d-axis resolution, see tests)
    edge_kernel: str = "auto"     # reduced-rule Charbonnier edge evaluator:
                                  # "xla" (scan + finalize passes), "pallas"
                                  # (fused GPU kernel,
                                  # kernels/edge_reduced_gq.py), "auto" (same
                                  # rule as node_kernel)
    gama: float = 1.0             # truncated-quadratic edge scale
    dta: float = 10.0             # truncation cutoff

    # --- annealing / entropy ---
    temperature: float = 0.0      # initial Bethe-entropy temperature T
    drate: float = 0.5            # geometric decay rate of T
    anneal_every: int = 0         # decay cadence in iters (0 = no annealing)
    t_floor: float = 1e-3         # T floor (gqmap_gpuSuper_mix_entropy.m:72)

    # --- optimization ---
    sweep_order: str = "jacobi"   # "jacobi": whole-grid gather-then-update,
                                  # the reference's synchronous sweep
                                  # (gqmap_gpu_mixture.m:29-46); "redblack":
                                  # checkerboard Gauss-Seidel — two half-
                                  # steps per sweep, each updating one
                                  # parity class against the other's FRESH
                                  # values (the classic stencil-relaxation
                                  # accuracy/speed knob, SURVEY.md §2.5).
                                  # Costs ~2x per sweep on dense kernels;
                                  # pays when it converges in fewer sweeps.
    its: int = 30000              # max sweeps
    step0: float = 0.1            # step = step0 / (1 + it/step_tau)
    step_tau: float = 8000.0      # inf => constant step (gqmap_ctf.m:27)
    sigma_step_scale: float = 1.0 # ctf damps sigma steps by 0.3 (gqmap_ctf.m:34)
    sigma_min: float = 0.01
    sigma_max: float = 23.0       # 25 in the Super/ctf variants
    corr_tor: float = 1.0 - 1e-5  # |rho| clamp (0.999 in ctf)
    border: int = 1               # frozen boundary ring (gqmap_gpu_mixture.m:11)
    tor: float = 1e-4             # convergence threshold on mean |dmu|

    # --- gradient estimator ---
    gradient_estimator: str = "stein"  # reference Stein identities;
                                       # "autodiff" (jax.grad of the quadrature
                                       # expectation; the vectorized heir of the
                                       # legacy/gqmap_gpuV3.m analytic-derivative
                                       # estimator family); or "prewitt" (the
                                       # literal gpuV3 family: quadrature of the
                                       # chain-rule df/dx using precomputed
                                       # Prewitt image-gradient fields,
                                       # legacy/gqmap_gpuV3.m:17-22,91-125 —
                                       # requires data_term="nearest")

    # --- mixture weights ---
    alpha_update: str = "softmax_natural"  # or "projsplx" (gqmap_gpu_mixture.m:49-50)
    alpha_start: int = 500        # first iteration the alpha update runs after
    alpha_lr_scale: float = 1e-7  # lr = step * alpha_lr_scale

    # --- evaluation / runtime ---
    eval_every: int = 300         # MAP/AEPE/logP cadence (gqmap_gpu_mixture.m:52)
    quad_chunk: int = 0           # quadrature points per scan step (0 = all K^2)
    dtype: str = "float32"        # state dtype ("float64" for the CPU golden model)
    seed: int = 0
    debug_finite: bool = False    # assert every state leaf finite after each
                                  # segment (the 1/(1-p^2) factors near the rho
                                  # clamp are the known blow-up mode,
                                  # gqmap_gpu_mixture.m:92-93); raises
                                  # FloatingPointError naming the leaf

    @property
    def step_const(self) -> bool:
        return math.isinf(self.step_tau)

    def step_at(self, it) -> float:
        if self.step_const:
            return self.step0
        return self.step0 / (1.0 + it / self.step_tau)

    # ------------------------------------------------------------------ presets
    @classmethod
    def full_mixture(cls, **kw) -> "GQMAPConfig":
        """Full-resolution L=3 mixture, T=0 (``optical_flow.m:16-23`` +
        ``gqmap_gpu_mixture.m``)."""
        return cls(**{**dict(
            K=9, its=30000, epsn=1e-6, lambdas=5.0, lambdad=1.0, L=3,
            temperature=0.0, drate=0.5, anneal_every=0,
            step0=0.1, step_tau=8000.0, sigma_max=23.0, patch=1,
        ), **kw})

    @classmethod
    def super_entropy(cls, **kw) -> "GQMAPConfig":
        """Quarter-res super lattice + entropy annealing
        (``optical_flowSuper.m:19-26`` + ``gqmap_gpuSuper_mix_entropy.m``)."""
        return cls(**{**dict(
            K=11, its=30000, epsn=1e-6, lambdas=16.0, lambdad=1.0, L=3,
            temperature=0.2, drate=0.75, anneal_every=500, t_floor=1e-3,
            step0=0.001, step_tau=4000.0, sigma_max=25.0, patch=4,
        ), **kw})

    @classmethod
    def single_gaussian(cls, **kw) -> "GQMAPConfig":
        """L=1 full-res solver (the modern equivalent of
        ``legacy/gqmap_gpuV2.m``)."""
        return cls.full_mixture(**{**dict(L=1), **kw})

    @classmethod
    def tpu_fast(cls, **kw) -> "GQMAPConfig":
        """Flagship mixture preset on the fast paths: the closed-form cosine
        data term (zero node quadrature) and the reduced 1-D edge
        quadrature (see PERF.md).

        Degrees 64x16 since r05: the measured accuracy frontier
        (``results/degrees_frontier.jsonl``) shows A=64 matches A=96 on
        both small-motion probes at 10000 its (RubberWhale 0.3703 vs
        0.3713, Dimetrodon 0.3669 vs 0.3671) and the 30000-it verification
        holds the campaign contract (``flag64x16_cosine`` rows), with 2/3
        of the node-term modes. B=16 is accuracy-load-bearing (B=12 costs +2.4% on
        RubberWhale); stereo-scale runs still size A to the GT
        displacement box (campaign uses 192 or, per the Teddy frontier
        points, 96-128 at <0.2% cost)."""
        return cls.full_mixture(**{**dict(
            data_term="cosine", cheb_p=64, cheb_q=16, quad_chunk=27,
            edge_quad="reduced",
        ), **kw})

    @classmethod
    def tpu_fast_super(cls, **kw) -> "GQMAPConfig":
        """The reference's strongest-accuracy variant (¼-res super lattice +
        entropy annealing, ``gqmap_gpuSuper_mix_entropy.m``) on the fast
        paths: the cosine data term expands the *patch-summed* node
        potential (``build_cos_data(patch=4)``), so the zero-quadrature
        closed form covers the 4x4-patch data term too."""
        return cls.super_entropy(**{**dict(
            data_term="cosine", cheb_p=96, cheb_q=16, quad_chunk=0,
            edge_quad="reduced",
        ), **kw})

    @classmethod
    def legacy_v1(cls, **kw) -> "GQMAPConfig":
        """Earliest solver family (``legacy/gqmap_cpu.m``): quadratic node
        prior toward an init flow + truncated-quadratic edges, L=1."""
        return cls(**{**dict(
            K=9, its=2000, L=1, data_term="quadratic", edge_kind="truncquad",
            quad_var=1.0, gama=1.0, dta=10.0,
            step0=0.1, step_tau=1000.0, corr_tor=0.97, sigma_max=25.0,
        ), **kw})

    @classmethod
    def legacy_v2(cls, **kw) -> "GQMAPConfig":
        """Windowed-data-cost family (``legacy/gqmap_cpuV2.m``): each pixel's
        data term is the mean Charbonnier cost over an overlapping rg=2
        window (displacement shared across the window), nearest lookup into
        the 2^6-x upsampled frame 2 (``:10-11,29-33``); L=1, border ring =
        rg (updates run ``rg+1:M-rg``, ``:22-23``)."""
        return cls.single_gaussian(**{**dict(
            data_term="nearest", rfc=6, window_rg=2, border=2,
            epsn=1e-4, tor=1e-3,
        ), **kw})

    @classmethod
    def legacy_v3(cls, **kw) -> "GQMAPConfig":
        """Image-gradient (Prewitt) estimator family (``legacy/gqmap_gpuV3.m``):
        node gradients by quadrature of the analytic chain-rule df/dx against
        precomputed Prewitt gradient fields of frame 2, nearest lookup at
        rfc=4 (``:15-23``); L=1, tor=1e-2 (``:26``)."""
        return cls.single_gaussian(**{**dict(
            data_term="nearest", rfc=4, gradient_estimator="prewitt",
            epsn=1e-4, tor=1e-2,
        ), **kw})

    @classmethod
    def blockmatch_v2(cls, **kw) -> "GQMAPConfig":
        """The block-matching-init experiment driver's solver settings
        (``legacy/optical_flow_temp.m:33-39``): gqmap_gpuV2 with K=17,
        its=5000, sg=1e-4, lambda_s=1.7, lambda_d=0.3."""
        return cls.single_gaussian(**{**dict(
            K=17, its=5000, epsn=1e-4, lambdas=1.7, lambdad=0.3,
            data_term="nearest", rfc=6,
        ), **kw})

    @classmethod
    def ctf_level(cls, **kw) -> "GQMAPConfig":
        """Single pyramid-level solver (``legacy/gqmap_ctf.m``): L=1,
        constant step 0.07, sigma-step damping 0.3, looser rho clamp."""
        return cls(**{**dict(
            K=11, its=3000, epsn=1e-6, lambdas=5.0, lambdad=1.0, L=1,
            temperature=0.0, anneal_every=0,
            step0=0.07, step_tau=math.inf, sigma_step_scale=0.3,
            sigma_max=25.0, corr_tor=0.999, patch=1,
        ), **kw})
