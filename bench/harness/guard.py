"""The import guard: no module of JAX, or of the JAX package the port
was made from, may be loaded in a benchmark run.

Module names are compared by their top-level name (the part before the
first dot), whole: ``repro_torch.serving`` passes, ``repro.core`` and
``jax.numpy`` do not.
"""
from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names: Iterable[str]) -> List[str]:
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def check(where: str, names: Optional[Iterable[str]] = None) -> None:
    """Raise naming every forbidden module that ``sys.modules`` (or
    ``names``) holds."""
    bad = forbidden_modules(list(sys.modules) if names is None else names)
    if bad:
        raise ImportError(f"import guard ({where}): forbidden modules "
                          f"loaded: {', '.join(bad)}")
