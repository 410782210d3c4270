"""The check that nothing in the process is JAX: the top-level name of
every loaded module (the part before the first dot), compared whole."""

from __future__ import annotations

import sys
from typing import List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax", "chex",
                       "speech2text_tpu"})


def jax_modules() -> List[str]:
    """The forbidden top-level names loaded now, sorted."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & FORBIDDEN)
