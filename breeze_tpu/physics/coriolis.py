"""Coriolis forces on the C-grid.

Equivalent of the reference's Oceananigans Coriolis types
(``FPlane``, ``BetaPlane``, ``ConstantCartesianCoriolis``; reference
``src/Breeze.jl:217-218``, used in ``dynamics_kernel_functions.jl:3``).
Each returns the components of ``f × (ρU)`` at the staggered momentum
locations, built from 4-point averages of the transverse momentum.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from ..ops import StencilOps


@dataclasses.dataclass(frozen=True)
class FPlane:
    """f-plane: constant rotation about ẑ."""

    f: float = 1.0e-4


@dataclasses.dataclass(frozen=True)
class BetaPlane:
    """f = f0 + β (y − y0)."""

    f0: float = 1.0e-4
    beta: float = 0.0
    y0: float = 0.0


@dataclasses.dataclass(frozen=True)
class HydrostaticSphericalCoriolis:
    """Traditional spherical Coriolis: f(φ) = 2Ω sinφ (no 2Ωcosφ coupling).

    Reference: ``HydrostaticSphericalCoriolis`` (compressible docs, spherical
    grids section)."""

    rotation_rate: float = 7.292115e-5


@dataclasses.dataclass(frozen=True)
class SphericalCoriolis:
    """Spherical Coriolis with the non-traditional 2Ωcosφ zonal-vertical
    coupling (reference ``SphericalCoriolis``)."""

    rotation_rate: float = 7.292115e-5


@dataclasses.dataclass(frozen=True)
class ConstantCartesianCoriolis:
    """Rotation vector with all three components (non-traditional terms)."""

    fx: float = 0.0
    fy: float = 0.0
    fz: float = 1.0e-4


@dataclasses.dataclass(frozen=True)
class NonTraditionalBetaPlane:
    """Non-traditional β-plane (Dellar 2011; reference re-export
    ``NonTraditionalBetaPlane``, ``src/Breeze.jl:181/217``): the vertical
    rotation component varies with y, the horizontal with z —

        f̃ᶻ(y) = fz + β (y − y0),    f̃ʸ(z) = fy + γ z,

    giving the energetically/vortically consistent mid-latitude expansion
    of the full Coriolis force.  From (Ω, φ₀, R): fz = 2Ω sinφ₀,
    fy = 2Ω cosφ₀, β = 2Ω cosφ₀/R, γ = −4Ω sinφ₀/R.
    """

    fz: float = 1.0e-4
    fy: float = 1.0e-4
    beta: float = 1.6e-11
    gamma: float = -3.1e-11
    y0: float = 0.0

    @classmethod
    def from_latitude(cls, latitude_deg, rotation_rate=7.292115e-5,
                      radius=6.371e6, y0=0.0):
        import math
        phi = math.radians(latitude_deg)
        return cls(fz=2.0 * rotation_rate * math.sin(phi),
                   fy=2.0 * rotation_rate * math.cos(phi),
                   beta=2.0 * rotation_rate * math.cos(phi) / radius,
                   gamma=-4.0 * rotation_rate * math.sin(phi) / radius,
                   y0=y0)


def _f_at(coriolis, y):
    if isinstance(coriolis, FPlane):
        return coriolis.f
    if isinstance(coriolis, BetaPlane):
        return coriolis.f0 + coriolis.beta * (y - coriolis.y0)
    raise TypeError(coriolis)


def coriolis_terms(coriolis, so: StencilOps, rho_u_pad, rho_v_pad, rho_w_pad, grid):
    """(f×ρU)_x at u-points, (f×ρU)_y at v-points, (f×ρU)_z at w-points.

    These are *subtracted* in the momentum tendencies (reference
    ``x_f_cross_U`` sign convention: G += −f×U).
    """
    if coriolis is None:
        return 0.0, 0.0, 0.0

    if isinstance(coriolis, ConstantCartesianCoriolis):
        fx, fy, fz = coriolis.fx, coriolis.fy, coriolis.fz
        # Full cross product f × ρU on the C-grid; transverse momentum is
        # interpolated with 4-point averages onto each component's location.
        rv_u = 0.25 * (so.v(rho_v_pad) + so.v(rho_v_pad, dy=1)
                       + so.v(rho_v_pad, dx=-1) + so.v(rho_v_pad, dy=1, dx=-1))
        rw_u = 0.25 * (so.v(rho_w_pad) + so.v(rho_w_pad, dz=1)
                       + so.v(rho_w_pad, dx=-1) + so.v(rho_w_pad, dz=1, dx=-1))
        ru_v = 0.25 * (so.v(rho_u_pad) + so.v(rho_u_pad, dx=1)
                       + so.v(rho_u_pad, dy=-1) + so.v(rho_u_pad, dx=1, dy=-1))
        rw_v = 0.25 * (so.v(rho_w_pad) + so.v(rho_w_pad, dz=1)
                       + so.v(rho_w_pad, dy=-1) + so.v(rho_w_pad, dz=1, dy=-1))
        ru_w = 0.25 * (so.v(rho_u_pad) + so.v(rho_u_pad, dx=1)
                       + so.v(rho_u_pad, dz=-1) + so.v(rho_u_pad, dx=1, dz=-1))
        rv_w = 0.25 * (so.v(rho_v_pad) + so.v(rho_v_pad, dy=1)
                       + so.v(rho_v_pad, dz=-1) + so.v(rho_v_pad, dy=1, dz=-1))
        x_term = fy * rw_u - fz * rv_u
        y_term = fz * ru_v - fx * rw_v
        z_term = fx * rv_w - fy * ru_w
        return x_term, y_term, z_term

    if isinstance(coriolis, NonTraditionalBetaPlane):
        g = so.grid
        y_c = jnp.asarray(grid.y_c(), g.dtype)[None, :, None]
        y_f = jnp.asarray(grid.y_f(), g.dtype)[None, :, None]
        z_c = g.z_c_col
        z_f = g.z_f_col
        fz_c = coriolis.fz + coriolis.beta * (y_c - coriolis.y0)
        fz_f = coriolis.fz + coriolis.beta * (y_f - coriolis.y0)
        fy_c = coriolis.fy + coriolis.gamma * z_c    # at z-centers
        fy_zf = coriolis.fy + coriolis.gamma * z_f   # at z-faces
        rv_u = 0.25 * (so.v(rho_v_pad) + so.v(rho_v_pad, dy=1)
                       + so.v(rho_v_pad, dx=-1) + so.v(rho_v_pad, dy=1, dx=-1))
        rw_u = 0.25 * (so.v(rho_w_pad) + so.v(rho_w_pad, dz=1)
                       + so.v(rho_w_pad, dx=-1) + so.v(rho_w_pad, dz=1, dx=-1))
        ru_v = 0.25 * (so.v(rho_u_pad) + so.v(rho_u_pad, dx=1)
                       + so.v(rho_u_pad, dy=-1) + so.v(rho_u_pad, dx=1, dy=-1))
        ru_w = 0.25 * (so.v(rho_u_pad) + so.v(rho_u_pad, dx=1)
                       + so.v(rho_u_pad, dz=-1) + so.v(rho_u_pad, dx=1, dz=-1))
        x_term = fy_c * rw_u - fz_c * rv_u
        y_term = fz_f * ru_v
        z_term = -fy_zf * ru_w
        return x_term, y_term, z_term

    if isinstance(coriolis, (HydrostaticSphericalCoriolis, SphericalCoriolis)):
        assert grid.is_latlon, "spherical Coriolis needs a lat-lon grid"
        two_omega = 2.0 * coriolis.rotation_rate
        sin_c = grid.tanlat_c * grid.coslat_c            # sinφ at y-centers
        sin_f = (grid.tanlat_f * grid.coslat_f)[: grid.ny]
        f_c = two_omega * sin_c[None, :, None]
        f_f = two_omega * sin_f[None, :, None]
        rv_u = 0.25 * (so.v(rho_v_pad) + so.v(rho_v_pad, dy=1)
                       + so.v(rho_v_pad, dx=-1) + so.v(rho_v_pad, dy=1, dx=-1))
        ru_v = 0.25 * (so.v(rho_u_pad) + so.v(rho_u_pad, dx=1)
                       + so.v(rho_u_pad, dy=-1) + so.v(rho_u_pad, dx=1, dy=-1))
        x_term = -f_c * rv_u
        y_term = f_f * ru_v
        z_term = 0.0
        if isinstance(coriolis, SphericalCoriolis):
            # non-traditional 2Ωcosφ zonal↔vertical coupling
            cos_c = grid.coslat_c[None, :, None]
            e_c = two_omega * cos_c
            rw_u = 0.25 * (so.v(rho_w_pad) + so.v(rho_w_pad, dz=1)
                           + so.v(rho_w_pad, dx=-1) + so.v(rho_w_pad, dz=1, dx=-1))
            ru_w = 0.25 * (so.v(rho_u_pad) + so.v(rho_u_pad, dx=1)
                           + so.v(rho_u_pad, dz=-1) + so.v(rho_u_pad, dx=1, dz=-1))
            x_term = x_term + e_c * rw_u
            z_term = -e_c * ru_w
        return x_term, y_term, z_term

    # Traditional f(y) ẑ × U
    y_c = jnp.asarray(grid.y_c(), so.grid.dtype)[None, :, None]
    y_f = jnp.asarray(grid.y_f(), so.grid.dtype)[None, :, None]
    f_c = _f_at(coriolis, y_c)   # at y-centers (u-points)
    f_f = _f_at(coriolis, y_f)   # at y-faces (v-points)

    rv_u = 0.25 * (so.v(rho_v_pad) + so.v(rho_v_pad, dy=1)
                   + so.v(rho_v_pad, dx=-1) + so.v(rho_v_pad, dy=1, dx=-1))
    ru_v = 0.25 * (so.v(rho_u_pad) + so.v(rho_u_pad, dx=1)
                   + so.v(rho_u_pad, dy=-1) + so.v(rho_u_pad, dx=1, dy=-1))
    return -f_c * rv_u, f_f * ru_v, 0.0
