"""What a run refuses: too few cards, and the JAX side of the repository
in the process that prints the result."""

from __future__ import annotations

import sys

# Top-level module names, compared whole: ``apv_tpu_torch`` is not
# ``apv_tpu``.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "apv_tpu")


class Refusal(Exception):
    """The run cannot give a result; the message says why."""


def forbidden_modules(modules=None) -> list[str]:
    """Names in ``modules`` (default ``sys.modules``) whose part before the
    first dot is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def require_cards(count: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise Refusal("no CUDA device: torch.cuda.is_available() is false")
    have = torch.cuda.device_count()
    if have < count:
        raise Refusal(f"the cell asks for {count} cards; "
                      f"torch.cuda.device_count() is {have}")
