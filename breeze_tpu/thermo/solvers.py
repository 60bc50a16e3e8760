"""Fixed-trip-count scalar solvers for EOS inversions and saturation adjustment.

Equivalent of reference ``src/Solvers.jl`` (NewtonSolver :61,
SecantSolver :92, FixedIterations :134).  The reference notes (:13-19) that
tolerance ``while``-loops trace to pathological XLA ``while`` adjoints — the
same constraint applies natively here, so the default is a *fixed* iteration
count unrolled (or ``lax.fori_loop``-ed) with no convergence branch; this is
batched over whole fields, not per-cell scalars.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class FixedIterations:
    """Run exactly ``iterations`` steps; trace-friendly, AD-friendly."""

    iterations: int = 3


@dataclasses.dataclass(frozen=True)
class NewtonSolver:
    """Newton iteration with derivative from ``jax.grad``-style callable."""

    iterations: int = 3
    damping: float = 1.0


@dataclasses.dataclass(frozen=True)
class SecantSolver:
    iterations: int = 5
    perturbation: float = 1e-3


def newton_solve(residual: Callable, x0, iterations: int = 3,
                 derivative: Callable | None = None, damping: float = 1.0):
    """Batched Newton: x <- x - damping * r(x) / r'(x), fixed trip count.

    ``residual`` maps arrays to arrays elementwise.  If ``derivative`` is not
    given it is obtained by forward-mode AD (``jax.jvp`` with a ones tangent),
    which vectorizes over the whole field at once.
    """
    def deriv(x):
        if derivative is not None:
            return derivative(x)
        _, d = jax.jvp(residual, (x,), (jnp.ones_like(x),))
        return d

    x = x0
    for _ in range(iterations):
        r = residual(x)
        dr = deriv(x)
        x = x - damping * r / dr
    return x


def secant_solve(residual: Callable, x0, x1=None, iterations: int = 5,
                 perturbation: float = 1e-3):
    """Batched secant iteration with fixed trip count.

    Guards against zero secant slope by falling back to no update there
    (matching the reference's behavior of returning the current iterate when
    the bracket degenerates, ``src/Solvers.jl:243-270``).
    """
    if x1 is None:
        x1 = x0 * (1.0 + perturbation)
    r0 = residual(x0)
    for _ in range(iterations):
        r1 = residual(x1)
        dr = r1 - r0
        safe = jnp.where(jnp.abs(dr) > 0, dr, jnp.ones_like(dr))
        x2 = jnp.where(jnp.abs(dr) > 0, x1 - r1 * (x1 - x0) / safe, x1)
        x0, r0, x1 = x1, r1, x2
    return x1


def solve(residual: Callable, x0, solver, derivative: Callable | None = None):
    """Dispatch on solver config (NewtonSolver / SecantSolver / FixedIterations)."""
    if isinstance(solver, NewtonSolver):
        return newton_solve(residual, x0, solver.iterations, derivative, solver.damping)
    if isinstance(solver, SecantSolver):
        return secant_solve(residual, x0, iterations=solver.iterations,
                            perturbation=solver.perturbation)
    if isinstance(solver, FixedIterations):
        return newton_solve(residual, x0, solver.iterations, derivative)
    raise TypeError(f"unknown solver {solver!r}")
