"""The one decision of which scan runs.

Every engine that is not told otherwise asks :func:`choose_scan`. On a GPU
the scan is the Pallas kernel (ops/myers_pallas.py), compiled for the card;
on the CPU it is the XLA scan (``scan_core`` in ops/myers_xla.py). The
kernel runs in the Pallas interpreter only when a caller asks for it.
"""

from __future__ import annotations

__all__ = ["choose_scan", "lane_multiple", "pad_lanes_for"]

#: scan backend per JAX platform
_BY_PLATFORM = {"gpu": "pallas", "cpu": "xla"}


def choose_scan(interpret: bool = False) -> tuple[str, bool]:
    """Return ``(backend, interpret)`` for the default JAX platform:
    ``("pallas", False)`` on a GPU, ``("xla", False)`` on the CPU, and
    ``("pallas", True)`` whenever ``interpret`` is requested. Any other
    platform raises."""
    if interpret:
        return "pallas", True
    import jax

    platform = jax.default_backend()
    if platform not in _BY_PLATFORM:
        raise RuntimeError(f"no scan backend for JAX platform {platform!r}")
    return _BY_PLATFORM[platform], False


def lane_multiple(backend: str) -> int:
    """The lane count ``backend``'s scan reads a multiple of: whole
    ``LANE_BLOCK``s for the kernel, any count for the XLA scan."""
    if backend != "pallas":
        return 1
    from .myers_pallas import LANE_BLOCK

    return LANE_BLOCK


def pad_lanes_for(backend: str, n: int) -> int:
    """Round the lane count ``n`` up to a multiple of :func:`lane_multiple`."""
    b = lane_multiple(backend)
    return -(-n // b) * b
