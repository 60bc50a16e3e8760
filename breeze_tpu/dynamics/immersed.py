"""Immersed boundaries: grid-fitted bottom topography via cell masking.

Equivalent of the reference's Oceananigans immersed-boundary
substrate (``ImmersedBoundaryGrid``/``GridFittedBottom``; reference
``src/Breeze.jl:207``, used by the anelastic solver dispatch
``anelastic_pressure_solver.jl:15-21``): cells whose center lies below the
prescribed bottom height are solid; wall-adjacent face velocities are
masked to zero and tendencies vanish inside the solid.

As in the reference, the FFT pressure projection over an immersed grid is
*approximate* — it uses the underlying grid's solver and leaves a residual
divergence near the terrain (reference comment at
``anelastic_pressure_solver.jl:15-18``).  For terrain-fitted accuracy use
the σ-coordinate path (:mod:`breeze_tpu.dynamics.terrain`).

Masking is pure elementwise multiplication, fused by XLA
into the tendency kernels (the analogue of the reference's
``mask_immersed_field!`` + ``inactive_cell`` predicates).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..grid import Grid


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["bottom_height", "mask_c", "mask_u", "mask_v", "mask_w"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class GridFittedBottom:
    """Stair-step bottom topography masks (float 0/1 for fused multiplies)."""

    bottom_height: jax.Array   # (ny, nx)
    mask_c: jax.Array          # (nz, ny, nx) 1 = fluid cell
    mask_u: jax.Array          # x-face activity
    mask_v: jax.Array
    mask_w: jax.Array          # z-face activity (0 on faces touching solid)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["bottom_height", "mask_c", "mask_u", "mask_v", "mask_w",
                 "dz_c3", "frac_c", "frac_u", "frac_v"],
    meta_fields=["minimum_fraction"],
)
@dataclasses.dataclass(frozen=True)
class PartialCellBottom:
    """Partial-cell bottom topography (reference re-export
    ``PartialCellBottom``, ``src/Breeze.jl:182/207`` — Oceananigans'
    partial-cell immersed boundary).

    The lowest fluid cell of each column is *shortened* to the open
    height z_f[k+1] − h (clamped to ≥ ``minimum_fraction``·Δz), instead of
    stair-stepping to the nearest face.  Cells whose open height would be
    below the minimum fraction are solid.

    Finite-volume consequence: a partial cell's volume and its x/y face
    areas shrink by the open fraction.  The scalar flux divergence uses
    the exact area-weighted form — horizontal fluxes × face fraction
    (min of the adjacent columns), divergence ÷ cell fraction, vertical
    divergence ÷ partial thickness — which keeps Σ (ρc)·V exactly
    conservative.  Momentum advection uses the thickness correction only
    (first-order in the fraction mismatch, like the reference's immersed
    momentum handling); the FFT projection stays approximate over the
    immersed cells, as for :class:`GridFittedBottom`.
    """

    bottom_height: jax.Array   # (ny, nx)
    mask_c: jax.Array          # (nz, ny, nx) 1 = fluid cell
    mask_u: jax.Array
    mask_v: jax.Array
    mask_w: jax.Array
    dz_c3: jax.Array           # partial cell thickness at centers (3-D)
    frac_c: jax.Array          # open fraction of each cell (1 in interior)
    frac_u: jax.Array          # open fraction at x-faces (min of neighbors)
    frac_v: jax.Array          # at y-faces
    minimum_fraction: float = 0.2

    @property
    def dz_u3(self):
        """Partial thickness at x-face momentum locations."""
        return self.frac_u * self.dz_c3 / jnp.maximum(self.frac_c, 1e-30)

    @property
    def dz_v3(self):
        return self.frac_v * self.dz_c3 / jnp.maximum(self.frac_c, 1e-30)


def _bottom_height_array(grid, bottom):
    ny, nx = grid.ny, grid.nx
    if callable(bottom):
        x = grid.x_c()[None, :]
        y = grid.y_c()[:, None]
        return np.asarray(bottom(x, y), np.float64) * np.ones((ny, nx))
    return np.asarray(bottom, np.float64) * np.ones((ny, nx))


def make_partial_cell_bottom(grid: Grid, bottom: Callable | np.ndarray,
                             minimum_fraction: float = 0.2) -> PartialCellBottom:
    """Partial-cell bottom: cell k is fluid iff its open height
    z_f[k+1] − h ≥ ``minimum_fraction``·Δz_k; the lowest fluid cell's
    thickness is the (clamped) open height."""
    h = _bottom_height_array(grid, bottom)
    z_f = np.asarray(grid.z_f, np.float64)
    dz_c = np.asarray(grid.dz_c, np.float64)

    open_h = z_f[1:, None, None] - h[None]              # (nz, ny, nx)
    dz3_full = dz_c[:, None, None] * np.ones_like(open_h)
    min_h = minimum_fraction * dz3_full
    fluid = open_h >= min_h

    # partial thickness: full Δz above the terrain cell, clamped open
    # height in the cell containing the terrain, full Δz in the solid
    # (masked — keep divisors benign).
    dz3 = np.where(fluid, np.minimum(open_h, dz3_full), dz3_full)
    frac = dz3 / dz3_full

    mask_c = fluid
    mask_u = fluid & np.roll(fluid, 1, axis=2)
    mask_v = fluid & np.roll(fluid, 1, axis=1)
    below = np.concatenate([np.zeros_like(fluid[:1]), fluid[:-1]], axis=0)
    mask_w = fluid & below

    frac_u = np.minimum(frac, np.roll(frac, 1, axis=2))
    frac_v = np.minimum(frac, np.roll(frac, 1, axis=1))

    dt = grid.dtype
    return PartialCellBottom(
        bottom_height=jnp.asarray(h, dt),
        mask_c=jnp.asarray(mask_c, dt),
        mask_u=jnp.asarray(mask_u, dt),
        mask_v=jnp.asarray(mask_v, dt),
        mask_w=jnp.asarray(mask_w, dt),
        dz_c3=jnp.asarray(dz3, dt),
        frac_c=jnp.asarray(frac, dt),
        frac_u=jnp.asarray(frac_u, dt),
        frac_v=jnp.asarray(frac_v, dt),
        minimum_fraction=float(minimum_fraction),
    )


def make_grid_fitted_bottom(grid: Grid, bottom: Callable | np.ndarray) -> GridFittedBottom:
    ny, nx = grid.ny, grid.nx
    h = _bottom_height_array(grid, bottom)

    z_c = np.asarray(grid.z_c, np.float64)[:, None, None]
    fluid = z_c > h[None]                               # (nz, ny, nx) bool

    mask_c = fluid
    mask_u = fluid & np.roll(fluid, 1, axis=2)          # face i: cells i-1, i
    mask_v = fluid & np.roll(fluid, 1, axis=1)
    below = np.concatenate([np.zeros_like(fluid[:1]), fluid[:-1]], axis=0)
    mask_w = fluid & below                              # face k: cells k-1, k

    dt = grid.dtype
    return GridFittedBottom(
        bottom_height=jnp.asarray(h, dt),
        mask_c=jnp.asarray(mask_c, dt),
        mask_u=jnp.asarray(mask_u, dt),
        mask_v=jnp.asarray(mask_v, dt),
        mask_w=jnp.asarray(mask_w, dt),
    )


def mask_state(ib: GridFittedBottom, state):
    """Zero momenta on solid-adjacent faces (``mask_immersed_field!``)."""
    return state.replace(
        rho_u=state.rho_u * ib.mask_u,
        rho_v=state.rho_v * ib.mask_v,
        rho_w=state.rho_w * ib.mask_w,
    )


def mask_tendencies(ib: GridFittedBottom, G):
    """Zero tendencies inside the solid (momenta on faces, scalars at centers)."""
    out = G.replace(
        rho_u=G.rho_u * ib.mask_u,
        rho_v=G.rho_v * ib.mask_v,
        rho_w=G.rho_w * ib.mask_w,
        rho_theta=G.rho_theta * ib.mask_c,
    )
    if G.rho_qt is not None:
        out = out.replace(rho_qt=G.rho_qt * ib.mask_c)
    if G.tracers:
        out = out.replace(tracers={k: v * ib.mask_c for k, v in G.tracers.items()})
    return out
