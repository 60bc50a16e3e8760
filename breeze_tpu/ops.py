"""Finite-volume stencil operators on halo-padded arrays.

Equivalent of the reference's Oceananigans operator library
(``∂xᶠᶜᶜ``, ``ℑzᵃᵃᶠ``, ``δ`` differences, ``divᶜᶜᶜ``; import surface at
reference ``src/Breeze.jl:168-197``).  Every operator is a pure function of
halo-padded arrays; the workhorse is :func:`sh`, a static shifted-window view
that XLA fuses into the consuming elementwise loop — there is no materialized
stencil traffic.

Axis order everywhere is ``(z, y, x)`` (axis 0 = z, 1 = y, 2 = x).

Staggering recap (see :mod:`breeze_tpu.grid`): face ``i`` is the lower edge
of cell ``i``.  Consequences for differences of padded arrays with halo h:

- center→face difference along x:  ``d_f[i] = c[i] - c[i-1]``
- face→center difference along x:  ``d_c[i] = u[i+1] - u[i]``
- center→face interpolation:        ``m_f[i] = (c[i] + c[i-1]) / 2``
- face→center interpolation:        ``m_c[i] = (u[i] + u[i+1]) / 2``
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .grid import Grid


def sh(a: jax.Array, h: int, shape: tuple[int, int, int],
       dz: int = 0, dy: int = 0, dx: int = 0) -> jax.Array:
    """Interior-sized window of padded array ``a`` shifted by (dz, dy, dx).

    ``sh(a, h, shape)`` is the interior; ``sh(a, h, shape, dx=1)`` is the
    interior shifted one cell in +x (i.e. element ``[k, j, i+1]``).
    """
    nz, ny, nx = shape
    return a[h + dz: h + dz + nz, h + dy: h + dy + ny, h + dx: h + dx + nx]


class StencilOps:
    """Operator bundle bound to a grid (spacings + shapes pre-bound).

    Methods take *padded* arrays (halo ``grid.halo``) and return
    interior-shaped arrays unless suffixed ``_p`` (padded output).
    """

    def __init__(self, grid: Grid):
        self.grid = grid
        self.h = grid.halo
        self.shape = grid.shape
        # z spacing columns, broadcastable to (nz, ny, nx)
        self.dz_c = grid.dz_c_col                    # Δz of cell k
        self.dz_f = grid.dz_f_col                    # Δz between centers k-1,k (face k)
        if grid.is_latlon:
            # spherical metric: ∂x = δx/(R cosφ Δλ); grid.dx stores R·Δλ.
            self.cosc_row = grid.coslat_c[None, :, None]
            self.cosf_row = grid.coslat_f[: grid.ny][None, :, None]
            self.inv_dx = 1.0 / (grid.dx * self.cosc_row)   # at y-center rows
            self.inv_dx_yface = 1.0 / (grid.dx * self.cosf_row)
        else:
            self.cosc_row = 1.0
            self.cosf_row = 1.0
            self.inv_dx = 1.0 / grid.dx
            self.inv_dx_yface = self.inv_dx
        self.inv_dy = 1.0 / grid.dy

    # -- shifted views -------------------------------------------------
    def v(self, a, dz=0, dy=0, dx=0):
        return sh(a, self.h, self.shape, dz, dy, dx)

    # -- differences ---------------------------------------------------
    def dx_cf(self, c):
        """∂x center→face: (c[i] - c[i-1]) / Δx."""
        return (self.v(c) - self.v(c, dx=-1)) * self.inv_dx

    def dx_fc(self, u):
        """∂x face→center: (u[i+1] - u[i]) / Δx."""
        return (self.v(u, dx=1) - self.v(u)) * self.inv_dx

    def dy_cf(self, c):
        return (self.v(c) - self.v(c, dy=-1)) * self.inv_dy

    def dy_fc(self, v_):
        return (self.v(v_, dy=1) - self.v(v_)) * self.inv_dy

    def dz_cf(self, c):
        """∂z center→face: (c[k] - c[k-1]) / Δz_f[k]."""
        return (self.v(c) - self.v(c, dz=-1)) / self.dz_f

    def dz_fc(self, w):
        """∂z face→center: (w[k+1] - w[k]) / Δz_c[k]."""
        return (self.v(w, dz=1) - self.v(w)) / self.dz_c

    # -- interpolations ------------------------------------------------
    def ix_cf(self, c):
        return 0.5 * (self.v(c) + self.v(c, dx=-1))

    def ix_fc(self, u):
        return 0.5 * (self.v(u, dx=1) + self.v(u))

    def iy_cf(self, c):
        return 0.5 * (self.v(c) + self.v(c, dy=-1))

    def iy_fc(self, v_):
        return 0.5 * (self.v(v_, dy=1) + self.v(v_))

    def iz_cf(self, c):
        return 0.5 * (self.v(c) + self.v(c, dz=-1))

    def iz_fc(self, w):
        return 0.5 * (self.v(w, dz=1) + self.v(w))

    # -- divergence of a face-located flux vector ----------------------
    def div_c(self, fx, fy, fz):
        """Cell-centered divergence of face fluxes (padded inputs).

        ``fx`` on x-faces, ``fy`` on y-faces, ``fz`` on z-faces; the
        z-derivative uses the stretched spacing.  On lat-lon grids the
        y-flux is cos-weighted (spherical FV form):
        div = δx(Fx)/(RcosφΔλ) + δy(cosφ_f Fy)/(Rcosφ_cΔφ) + δz(Fz)/Δz.
        """
        if self.grid.is_latlon:
            ny = self.grid.ny
            cosf_full = self.grid.coslat_f[None, :, None]   # (1, ny+1, 1)
            fy_w_lo = self.v(fy) * cosf_full[:, :ny]
            fy_w_hi = self.v(fy, dy=1) * jnp.concatenate(
                [cosf_full[:, 1:ny], cosf_full[:, ny:ny + 1]], axis=1)
            ddy = (fy_w_hi - fy_w_lo) * self.inv_dy / self.cosc_row
            return self.dx_fc(fx) + ddy + self.dz_fc(fz)
        return self.dx_fc(fx) + self.dy_fc(fy) + self.dz_fc(fz)


def column(profile_1d: jax.Array) -> jax.Array:
    """Lift a 1-D vertical profile ``(nz,)`` to a broadcastable column."""
    return profile_1d[:, None, None]


def face_profile_from_center(p_c: jnp.ndarray) -> jnp.ndarray:
    """Interpolate a center-located column profile to faces ``0..nz-1``.

    Face k averages centers k-1 and k; face 0 extrapolates the first center
    (matching the reference's bottom ``ValueBoundaryCondition`` treatment of
    reference profiles, ``reference_states.jl:402-430``).
    """
    nz = p_c.shape[0]
    out = jnp.empty_like(p_c)
    out = out.at[1:nz].set(0.5 * (p_c[1:] + p_c[:-1]))
    out = out.at[0].set(p_c[0])
    return out
