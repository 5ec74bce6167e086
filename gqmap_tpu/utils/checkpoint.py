"""Checkpoint / exact-resume of the solver state.

The reference only persists final results (``optical_flow.m:28``); for
long multi-device runs we checkpoint the full variational state
``(it, w, mu, sigma, pn, rou, T)`` plus config identity, enabling exact
resume after preemption (SURVEY.md section 5).
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np

from ..config import GQMAPConfig
from ..models.gqmap import GQState

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(path, state: GQState, cfg: GQMAPConfig | None = None, **extra):
    """Atomically write the solver state (and optional config) to ``path``."""
    path = os.fspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {f: np.asarray(getattr(state, f)) for f in state._fields}
    if cfg is not None:
        payload["__config__"] = np.frombuffer(
            json.dumps(dataclasses.asdict(cfg)).encode(), dtype=np.uint8
        )
    for k, v in extra.items():
        payload[f"extra_{k}"] = np.asarray(v)
    tmp = path + ".tmp"
    np.savez(tmp, **payload)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_checkpoint(path, expect_cfg: GQMAPConfig | None = None):
    """Load ``(state, cfg_or_None, extras)``; verifies config match if given.

    The ``its`` field is excluded from the match: resuming under a longer
    (or shorter) sweep budget is the standard extend-the-run usage and
    changes no per-sweep semantics (the step schedule depends on
    ``step_tau``, not ``its``).
    """
    with np.load(os.fspath(path)) as z:
        cfg = None
        if "__config__" in z:
            cfg = GQMAPConfig(**json.loads(bytes(z["__config__"]).decode()))
        if (
            expect_cfg is not None
            and cfg is not None
            and dataclasses.replace(cfg, its=expect_cfg.its) != expect_cfg
        ):
            raise ValueError("checkpoint config does not match the requested run")
        state = GQState(**{f: jnp.asarray(z[f]) for f in GQState._fields})
        extras = {k[6:]: z[k] for k in z.files if k.startswith("extra_")}
    return state, cfg, extras
