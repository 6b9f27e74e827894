"""The run's guard against the JAX package: by the end of a run, no
module of ``jax``, ``jaxlib``, ``flax`` or the JAX package ``bigsi_tpu``
may be loaded in the process.  Names compare whole, at their top level
(the part before the first dot), so the port ``bigsi_tpu_torch`` passes."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "bigsi_tpu"})


def forbidden_loaded(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & FORBIDDEN)
