"""Choices that depend on the backend, made in one place.

Everything else in the package is backend-agnostic JAX.  What differs by
backend is decided here, from what the code can observe
(``jax.default_backend()`` and the grid topology):

- the anelastic Poisson path: horizontal transform and vertical solve
  (:func:`poisson_path`);
- whether :class:`~breeze_tpu.simulation.Simulation` splits the domain over
  every visible device on its own (:func:`auto_distribute`);
- where the persistent compile cache lives (:func:`enable_compile_cache`).
"""

from __future__ import annotations

import os

import jax

# The fixed cache directory used when JAX_COMPILATION_CACHE_DIR is unset:
# inside the checkout (listed in .gitignore), never a temporary path, since
# the path is part of what makes a later run find the entries again.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def poisson_path(bounded: bool, backend: str | None = None) -> tuple[str, str]:
    """``(transform, vertical_solve)`` for the anelastic Poisson solver.

    On a GPU: the real eigenbasis with the vertical eigen solve, on every
    horizontal topology.  At 256^3 BOMEX on one NVIDIA H100 80GB HBM3 at a
    700 W power limit it takes 36.1 ms per step against 51.5 ms on
    fourier+scan (1.8-1.9 vs 5.1-6.5 ms per solve; ``tools/bench_micro.py``).

    Elsewhere: rfft2 with the Thomas scan, and the real (DCT-II) basis with
    the scan when an axis is bounded (the FFT does not diagonalise the
    Neumann operator).  The library FFT keeps a flow that is uniform along
    x exactly uniform; the real basis's matrix products seed 1e-16 noise
    there, which ``test_implicit_diffusion``'s buoyancy-unstable step
    (Δt = 2500 s, float64) grows from w ≈ 1e-25 to ρu ≈ 2e3 in ten steps.
    """
    if (backend or jax.default_backend()) == "gpu":
        return "real", "eigen"
    return ("real" if bounded else "fourier"), "scan"


def auto_distribute(backend: str | None = None) -> bool:
    """Whether ``Simulation`` splits the domain over all visible devices
    unasked.  Only on accelerators: virtual CPU device meshes gain nothing,
    and the in-process CPU collectives can time out under compile skew, so
    CPU runs opt in with ``distributed=True``."""
    return (backend or jax.default_backend()) != "cpu"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is the directory, and no other
    is set in code.  Otherwise the cache goes to :data:`DEFAULT_CACHE_DIR`.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
