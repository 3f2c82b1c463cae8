"""The import guard: no run may load JAX or the JAX package.

Names are compared whole, by their top-level part (before the first dot):
the port is ``repro_torch``, whose name begins with the JAX package's
``repro``, so a prefix test would be wrong.
"""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the modules
    this process has loaded), sorted."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
