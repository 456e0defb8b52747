"""The check that no module of JAX or of the JAX package is loaded.

Names are compared by whole components: a module belongs to JAX where its
top-level name is ``jax``, ``jaxlib`` or ``flax``, and to the JAX package
where its first two components are ``jutul`` and ``jl_tpu``. So
``jutul.jl_tpu_torch``, the port, belongs to neither.
"""

from __future__ import annotations

import sys

JAX_TOP = frozenset({"jax", "jaxlib", "flax"})
JAX_PACKAGE = ("jutul", "jl_tpu")


def is_forbidden(module: str) -> bool:
    parts = module.split(".")
    return parts[0] in JAX_TOP or tuple(parts[:2]) == JAX_PACKAGE


def forbidden_modules(modules=None) -> list:
    """The loaded (or given) module names that belong to JAX or the JAX
    package."""
    names = list(sys.modules) if modules is None else list(modules)
    return sorted(m for m in names if is_forbidden(m))
