"""gqmap_tpu: GQMAP dense-correspondence engine in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
motionlife/gqmap-opticalflow (MAP inference over pairwise image-grid MRFs
via Gauss-Hermite quadrature gradient ascent on Gaussian-mixture
variational families, specialized to dense optical flow): whole-lattice
vectorized sweeps, mesh-sharded grids with XLA-inserted collectives, and
Pallas GPU kernels for the hot path.
"""

from .config import FlowRange, GQMAPConfig
from .models.gqmap import GQState, SolveResult, solve

__version__ = "0.1.0"

__all__ = ["GQMAPConfig", "FlowRange", "GQState", "SolveResult", "solve"]
