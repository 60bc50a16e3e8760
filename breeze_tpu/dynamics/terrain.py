"""Terrain-following σ-coordinates for the compressible core.

Equivalent of reference ``src/TerrainFollowingDiscretization/``
(`TerrainFollowingVerticalDiscretization` ``terrain_following_vertical_
discretization.jl:20-83``, `LinearDecay` ``terrain_formulations.jl:30``,
`TerrainMetrics` ``terrain_metrics.jl:49-99``) and the terrain compressible
physics (``terrain_compressible_physics.jl``: contravariant transport
:200-253, slope-corrected PGFs :371-448, kinematic bottom :352).

Coordinate map (Gal-Chen/Somerville with linear decay):

    z(x, y, ζ) = ζ + h(x, y) · (1 − ζ/H),   ζ ∈ [0, H]

so the Jacobian J = ∂z/∂ζ = 1 − h/H is ζ-independent (a 2-D field) and the
slope  ∂z/∂x|_ζ = ∂h/∂x · (1 − ζ/H)  factorizes into a 2-D×1-D product —
the vectorization-friendly property this formulation is chosen for.

v1 scope: the fully explicit compressible path (acoustic-CFL Δt); the
terrain dispatch of the acoustic substepper is the round-2 extension.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from .. import fields as fl
from ..grid import Grid
from ..ops import StencilOps
from ..thermo.constants import ThermodynamicConstants
from .compressible import (CompressibleModel, CompressibleState,
                           eos_pressure)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["h_c", "jac_c", "jac_xf", "jac_yf", "sx_xf", "sy_yf",
                 "decay_c", "decay_f", "z_true_c", "p_ref", "rho_ref",
                 "h2_c", "sx2_xf", "sy2_yf", "basis2_c", "basis2_f",
                 "jac_cf"],
    meta_fields=["height"],
)
@dataclasses.dataclass(frozen=True)
class TerrainMetrics:
    """Precomputed terrain metric fields (reference ``TerrainMetrics``).

    2-D fields are (ny, nx); profiles (nz,)/(nz+1,); the 3-D hydrostatic
    reference (p_ref, rho_ref) is per-column over the terrain (reference's
    3-D ``ExnerReferenceState`` path, ``reference_states.jl:718``).

    Two formulations (reference ``terrain_formulations.jl``):

    - **LinearDecay** (Gal-Chen): z = ζ + h·(1−ζ/H).  J = 1 − h/H is
      ζ-independent, so ``jac_*`` are 2-D and the second-component fields
      are ``None``.
    - **TwoLevelDecay** (SLEVE, Schär et al. 2002, ``:88-200``): the terrain
      splits into a smoothed large-scale h₁ and residual small-scale h₂,
      each with a sinh decay basis bₙ(ζ) = sinh((H−ζ)/sₙ)/sinh(H/sₙ).
      z = ζ + h₁b₁ + h₂b₂; J = 1 + h₁b₁′ + h₂b₂′ depends on ζ, so ``jac_*``
      are 3-D (and ``jac_cf`` holds J at ζ-faces).  ``h_c``/``sx_xf``/
      ``decay_*`` then hold the large-scale component/basis and the ``*2``
      fields the small-scale one.
    """

    height: float                 # domain top H
    h_c: jax.Array                # surface elevation at centers (h₁ for SLEVE)
    jac_c: jax.Array              # J at (ζ-centers, xy-centers): 2-D or 3-D
    jac_xf: jax.Array             # J at x-faces (ζ-centers)
    jac_yf: jax.Array             # J at y-faces (ζ-centers)
    sx_xf: jax.Array              # ∂h/∂x at x-faces (2-D; ∂h₁/∂x for SLEVE)
    sy_yf: jax.Array              # ∂h/∂y at y-faces (2-D)
    decay_c: jax.Array            # decay basis b(ζ) at ζ-centers (nz,)
    decay_f: jax.Array            # at ζ-faces (nz,)  [stored faces 0..nz-1]
    z_true_c: jax.Array           # physical height of each cell (nz, ny, nx)
    p_ref: jax.Array              # hydrostatic reference pressure (3-D)
    rho_ref: jax.Array            # hydrostatic reference density (3-D)
    # SLEVE second component (None for LinearDecay):
    h2_c: jax.Array | None = None       # small-scale terrain at centers
    sx2_xf: jax.Array | None = None     # ∂h₂/∂x at x-faces
    sy2_yf: jax.Array | None = None     # ∂h₂/∂y at y-faces
    basis2_c: jax.Array | None = None   # b₂(ζ) at ζ-centers (nz,)
    basis2_f: jax.Array | None = None   # b₂(ζ) at ζ-faces (nz,)
    jac_cf: jax.Array | None = None     # J at (ζ-faces, xy-centers), 3-D

    # -- broadcastable 3-D Jacobian views (shape (1|nz, ny, nx)) ----------
    @property
    def jac_c3(self):
        return self.jac_c[None] if self.jac_c.ndim == 2 else self.jac_c

    @property
    def jac_xf3(self):
        return self.jac_xf[None] if self.jac_xf.ndim == 2 else self.jac_xf

    @property
    def jac_yf3(self):
        return self.jac_yf[None] if self.jac_yf.ndim == 2 else self.jac_yf

    @property
    def jac_cf3(self):
        """J at ζ-faces; for LinearDecay J is ζ-independent → jac_c3."""
        return self.jac_c3 if self.jac_cf is None else self.jac_cf

    @property
    def h_total(self):
        return self.h_c if self.h2_c is None else self.h_c + self.h2_c

    def slope_x(self, at_zface: bool):
        """Slope ∂z/∂x|_ζ at x-faces × (ζ-face or ζ-center) rows → 3-D."""
        decay = self.decay_f if at_zface else self.decay_c
        s = decay[:, None, None] * self.sx_xf[None]
        if self.sx2_xf is not None:
            b2 = self.basis2_f if at_zface else self.basis2_c
            s = s + b2[:, None, None] * self.sx2_xf[None]
        return s

    def slope_y(self, at_zface: bool):
        decay = self.decay_f if at_zface else self.decay_c
        s = decay[:, None, None] * self.sy_yf[None]
        if self.sy2_yf is not None:
            b2 = self.basis2_f if at_zface else self.basis2_c
            s = s + b2[:, None, None] * self.sy2_yf[None]
        return s


def make_terrain(grid: Grid, constants: ThermodynamicConstants,
                 surface_elevation: Callable | np.ndarray,
                 potential_temperature=300.0,
                 surface_pressure: float = 101325.0,
                 p_standard: float = 1.0e5,
                 smoothing_passes: int = 0,
                 large_scale_height: float | None = None,
                 small_scale_height: float | None = None,
                 sleve_smoothing_passes: int = 20) -> TerrainMetrics:
    """Materialize terrain metrics + the per-column hydrostatic reference.

    Mirrors reference ``materialize_terrain!`` (``materialize_terrain.jl:
    76-200``, incl. optional slope smoothing) and the per-column Newton
    reference integration (here: the discrete-balance recursion evaluated
    column-wise on the terrain's true heights).

    Passing both ``large_scale_height`` (s₁) and ``small_scale_height`` (s₂)
    selects the SLEVE / ``TwoLevelDecay`` formulation (reference
    ``terrain_formulations.jl:88-200``): the terrain is split into a
    smoothed large-scale part h₁ (``sleve_smoothing_passes`` diffusion
    passes) and the residual h₂, attenuated with
    bₙ(ζ) = sinh((H−ζ)/sₙ)/sinh(H/sₙ).  Otherwise the Gal-Chen linear
    decay b(ζ) = 1 − ζ/H is used.
    """
    ny, nx = grid.ny, grid.nx
    H = float(grid.Lz)

    if callable(surface_elevation):
        x = np.asarray(grid.x_c(), np.float64)[None, :]
        y = np.asarray(grid.y_c(), np.float64)[:, None]
        if grid.is_latlon:
            # callables receive (λ, φ) in radians, like initial_state
            x = x / grid.radius
            y = y / grid.radius
        h = np.asarray(surface_elevation(x, y), np.float64) * np.ones((ny, nx))
    else:
        h = np.asarray(surface_elevation, np.float64)

    def smooth(a, passes):
        for _ in range(passes):
            a = 0.25 * (np.roll(a, 1, 1) + np.roll(a, -1, 1)
                        + np.roll(a, 1, 0) + np.roll(a, -1, 0))
        return a

    h = smooth(h, smoothing_passes)

    sleve = large_scale_height is not None or small_scale_height is not None
    if sleve and (large_scale_height is None or small_scale_height is None):
        raise ValueError("SLEVE needs both large_scale_height and "
                         "small_scale_height")

    zeta_c = np.asarray(grid.z_c, np.float64)
    zeta_f = np.asarray(grid.z_f, np.float64)[: grid.nz]

    # Lat-lon: the zonal arc spacing at latitude φ is R·cosφ·Δλ (grid.dx
    # stores the equatorial arc R·Δλ); slopes and the slope PGF then flow
    # through the metric-aware StencilOps unchanged.
    if grid.is_latlon:
        dx_row = grid.dx * np.maximum(np.asarray(grid.coslat_c,
                                                 np.float64), 1e-12)[:, None]
    else:
        dx_row = grid.dx

    def face_means_and_slopes(hh):
        h_xf = 0.5 * (hh + np.roll(hh, 1, axis=1))   # x-face i between i-1, i
        h_yf = 0.5 * (hh + np.roll(hh, 1, axis=0))
        sx = (hh - np.roll(hh, 1, axis=1)) / dx_row
        sy = (hh - np.roll(hh, 1, axis=0)) / grid.dy
        return h_xf, h_yf, sx, sy

    h2 = sx2_xf = sy2_yf = basis2_c = basis2_f = jac_cf = None
    if sleve:
        s1, s2 = float(large_scale_height), float(small_scale_height)
        h1 = smooth(h, sleve_smoothing_passes)
        h2 = h - h1
        b = lambda zeta, s: np.sinh((H - zeta) / s) / np.sinh(H / s)
        db = lambda zeta, s: -np.cosh((H - zeta) / s) / (s * np.sinh(H / s))
        decay_c, decay_f = b(zeta_c, s1), b(zeta_f, s1)
        basis2_c, basis2_f = b(zeta_c, s2), b(zeta_f, s2)
        db1_c, db1_f = db(zeta_c, s1), db(zeta_f, s1)
        db2_c, db2_f = db(zeta_c, s2), db(zeta_f, s2)

        h1_xf, h1_yf, sx_xf, sy_yf = face_means_and_slopes(h1)
        h2_xf, h2_yf, sx2_xf, sy2_yf = face_means_and_slopes(h2)

        def jac3(h1_2d, h2_2d, db1, db2):
            return (1.0 + h1_2d[None] * db1[:, None, None]
                    + h2_2d[None] * db2[:, None, None])

        jac_c = jac3(h1, h2, db1_c, db2_c)
        jac_xf = jac3(h1_xf, h2_xf, db1_c, db2_c)
        jac_yf = jac3(h1_yf, h2_yf, db1_c, db2_c)
        jac_cf = jac3(h1, h2, db1_f, db2_f)
        jmin = min(jac_c.min(), jac_xf.min(), jac_yf.min(), jac_cf.min())
        if jmin <= 0.05:
            raise ValueError(
                f"SLEVE Jacobian min {jmin:.3f} ≤ 0.05: grid levels fold "
                "over the terrain — increase the decay scale heights")
        z_true_c = (zeta_c[:, None, None] + h1[None] * decay_c[:, None, None]
                    + h2[None] * basis2_c[:, None, None])
        h_for_metrics = h1
    else:
        jac_c = 1.0 - h / H
        h_xf, h_yf, sx_xf, sy_yf = face_means_and_slopes(h)
        jac_xf = 1.0 - h_xf / H
        jac_yf = 1.0 - h_yf / H
        decay_c = 1.0 - zeta_c / H
        decay_f = 1.0 - zeta_f / H
        # physical heights per column
        z_true_c = zeta_c[:, None, None] + h[None] * decay_c[:, None, None]
        h_for_metrics = h

    # per-column discretely-balanced dry hydrostatic reference on the TRUE
    # heights (vectorized over all columns; Newton as in
    # make_exner_reference_state but with array levels)
    Rd = constants.Rd
    cpd = constants.dry_air.heat_capacity
    kappa = Rd / cpd
    g_acc = constants.gravitational_acceleration
    theta_fn = (potential_temperature if callable(potential_temperature)
                else (lambda z: float(potential_temperature) * np.ones_like(z)))

    nz = grid.nz
    p_ref = np.empty((nz, ny, nx))
    rho_ref = np.empty((nz, ny, nx))
    theta_lv = np.asarray(theta_fn(z_true_c), np.float64) * np.ones_like(z_true_c)

    # anchor at the lowest cell via continuous Exner from the surface
    Pi_surf = (surface_pressure / p_standard) ** kappa
    dz0 = z_true_c[0] - h
    Pi0 = Pi_surf - g_acc * dz0 / (cpd * theta_lv[0])
    p_ref[0] = p_standard * np.maximum(Pi0, 1e-10) ** (1.0 / kappa)
    rho_ref[0] = p_ref[0] ** (1.0 - kappa) * p_standard ** kappa / (Rd * theta_lv[0])

    for k in range(1, nz):
        dzf = z_true_c[k] - z_true_c[k - 1]
        th = theta_lv[k]

        def rho_of(pp):
            return pp ** (1.0 - kappa) * p_standard ** kappa / (Rd * th)

        Pi_prev = (p_ref[k - 1] / p_standard) ** kappa
        Pi_guess = Pi_prev - g_acc * dzf / (cpd * th)
        pp = p_standard * np.maximum(Pi_guess, 1e-10) ** (1.0 / kappa)
        for _ in range(25):
            F = (pp - p_ref[k - 1]) / dzf + g_acc * 0.5 * (rho_of(pp) + rho_ref[k - 1])
            dF = 1.0 / dzf + g_acc * 0.5 * (1.0 - kappa) * rho_of(pp) / pp
            pp = pp - F / dF
        p_ref[k] = pp
        rho_ref[k] = rho_of(pp)

    dt = grid.dtype
    opt = lambda a: None if a is None else jnp.asarray(a, dt)
    return TerrainMetrics(
        height=H,
        h_c=jnp.asarray(h_for_metrics, dt),
        jac_c=jnp.asarray(jac_c, dt),
        jac_xf=jnp.asarray(jac_xf, dt),
        jac_yf=jnp.asarray(jac_yf, dt),
        sx_xf=jnp.asarray(sx_xf, dt),
        sy_yf=jnp.asarray(sy_yf, dt),
        decay_c=jnp.asarray(decay_c, dt),
        decay_f=jnp.asarray(decay_f, dt),
        z_true_c=jnp.asarray(z_true_c, dt),
        p_ref=jnp.asarray(p_ref, dt),
        rho_ref=jnp.asarray(rho_ref, dt),
        h2_c=opt(h2),
        sx2_xf=opt(sx2_xf),
        sy2_yf=opt(sy2_yf),
        basis2_c=opt(basis2_c),
        basis2_f=opt(basis2_f),
        jac_cf=opt(jac_cf),
    )


# ---------------------------------------------------------------------------
# Terrain-aware explicit compressible stepping
# ---------------------------------------------------------------------------

def contravariant_rho_w(terrain: TerrainMetrics, so: StencilOps,
                        rho_u_pad, rho_v_pad, rho_w):
    """ρw̃ = ρw − sx·ℑ(ρu) − sy·ℑ(ρv) at ζ-faces.

    Reference ``compute_contravariant_velocity!``
    (``terrain_compressible_physics.jl:200-253``): the slope-weighted
    horizontal momenta are interpolated to the (center-x, center-y, ζ-face)
    location with 4-point averages.
    """
    sx = terrain.slope_x(at_zface=True)       # at (zf, yc, xf) conceptually
    sy = terrain.slope_y(at_zface=True)
    # ℑxz(ρu): x-face → center in x, center → face in z
    ru_czf = 0.25 * (so.v(rho_u_pad) + so.v(rho_u_pad, dx=1)
                     + so.v(rho_u_pad, dz=-1) + so.v(rho_u_pad, dx=1, dz=-1))
    rv_czf = 0.25 * (so.v(rho_v_pad) + so.v(rho_v_pad, dy=1)
                     + so.v(rho_v_pad, dz=-1) + so.v(rho_v_pad, dy=1, dz=-1))
    # slope at x-face must also move to center-x: average sx to centers
    from ..parallel.halo import wrap_roll as _wr
    sx_c = 0.5 * (sx + _wr(sx, -1, 2))
    sy_c = 0.5 * (sy + _wr(sy, -1, 1))
    return rho_w - sx_c * ru_czf - sy_c * rv_czf


def kinematic_bottom_rho_w(terrain: TerrainMetrics, so: StencilOps,
                           rho_u, rho_v):
    """ρw at the surface face from impenetrability ρw̃ = 0 (reference :352):
    ρw|₀ = sx·ℑ(ρu)|₀ + sy·ℑ(ρv)|₀ with the slope at the bottom ζ-face."""
    sx0 = terrain.slope_x(at_zface=True)[0]
    sy0 = terrain.slope_y(at_zface=True)[0]
    # 2-D (y, x) slabs: axes 1/0 here are global axes 2/1 — keep the
    # shard-aware wrap on 3-D forms, then slice (wrap_roll needs the axis
    # numbering of the shard context, which is registered in 3-D terms).
    from ..parallel.halo import wrap_roll as _wr
    sx_c0 = 0.5 * (sx0 + _wr(sx0[None], -1, 2)[0])
    sy_c0 = 0.5 * (sy0 + _wr(sy0[None], -1, 1)[0])
    ru0 = 0.5 * (rho_u[0] + _wr(rho_u[:1], -1, 2)[0])
    rv0 = 0.5 * (rho_v[0] + _wr(rho_v[:1], -1, 1)[0])
    return sx_c0 * ru0 + sy_c0 * rv0


def terrain_pressure_gradients(terrain: TerrainMetrics, so: StencilOps,
                               p_pert_pad):
    """Slope-corrected horizontal PGFs (reference :371-448):

        (∂p/∂x)_z = (∂p/∂ζx)|_ζ − (∂z/∂x)_ζ ∂p/∂z
    """
    dpdx_zeta = so.dx_cf(p_pert_pad)                 # at x-faces
    dpdy_zeta = so.dy_cf(p_pert_pad)
    dpdz_c_f = so.dz_cf(p_pert_pad)                  # at ζ-faces (centers x,y)
    # ∂p/∂z true: divide by J at the ζ-faces
    dpdz_true_f = dpdz_c_f / terrain.jac_cf3
    # interpolate to x-faces / y-faces and back to ζ-centers
    dpdz_cc = 0.5 * (dpdz_true_f + jnp.concatenate(
        [dpdz_true_f[1:], dpdz_true_f[-1:]], axis=0))     # ζ-centers
    from ..parallel.halo import wrap_roll as _wr2
    dpdz_xf = 0.5 * (dpdz_cc + _wr2(dpdz_cc, 1, 2))
    dpdz_yf = 0.5 * (dpdz_cc + _wr2(dpdz_cc, 1, 1))
    sx = terrain.slope_x(at_zface=False)
    sy = terrain.slope_y(at_zface=False)
    dpdx_true = dpdx_zeta - sx * dpdz_xf
    dpdy_true = dpdy_zeta - sy * dpdz_yf
    return dpdx_true, dpdy_true, dpdz_true_f


def terrain_explicit_rk3_step(model: CompressibleModel,
                              terrain: TerrainMetrics,
                              state: CompressibleState, dt) -> CompressibleState:
    """SSP-RK3 fully explicit compressible step over terrain.

    Flux-form equations in σ-coordinates: ∂t(Jρ) + ∇ζ·(Jρu, Jρv, ρw̃) = 0
    etc.; with the ζ-independent Jacobian of the linear decay the J factors
    appear only as 2-D weights.  Reference: the terrain dispatches of
    ``compressible_density_tendency.jl`` + ``terrain_compressible_physics.jl``.
    """
    from .. import advection as adv
    from ..physics.coriolis import coriolis_terms

    g = model.grid
    so = model.stencil_ops()
    c = model.constants
    g_acc = c.gravitational_acceleration

    jac_c3 = terrain.jac_c3
    jac_xf3 = terrain.jac_xf3
    jac_yf3 = terrain.jac_yf3

    alphas = (1.0, 0.25, 2.0 / 3.0)
    s0 = state
    for alpha in alphas:
        rho_u_pad = fl.pad(state.rho_u, g, fl.CCF)
        rho_v_pad = fl.pad(state.rho_v, g, fl.CFC)
        rho_w_tilde = contravariant_rho_w(terrain, so, rho_u_pad, rho_v_pad,
                                          state.rho_w)
        rho_w_tilde = rho_w_tilde.at[0].set(0.0)      # terrain impenetrability
        rwt_pad = fl.pad(rho_w_tilde, g, fl.FCC)

        # velocities for reconstruction (contravariant vertical)
        rho_pad1 = fl.pad(state.rho, g, fl.CCC)
        u = state.rho_u / (0.5 * (so.v(rho_pad1) + so.v(rho_pad1, dx=-1)))
        v = state.rho_v / (0.5 * (so.v(rho_pad1) + so.v(rho_pad1, dy=-1)))
        wt = rho_w_tilde / (0.5 * (so.v(rho_pad1) + so.v(rho_pad1, dz=-1)))
        u_pad = fl.pad(u, g, fl.CCF)
        v_pad = fl.pad(v, g, fl.CFC)
        wt_pad = fl.pad(wt, g, fl.FCC)

        # J-weighted advecting momenta for the σ-coordinate flux form
        jru_pad = fl.pad(state.rho_u * jac_xf3, g, fl.CCF)
        jrv_pad = fl.pad(state.rho_v * jac_yf3, g, fl.CFC)

        # mass: ∂t(Jρ) = −[δx(Jρu) + δy(Jρv) + δζ(ρw̃)]
        G_rho = -so.div_c(jru_pad, jrv_pad, rwt_pad) / jac_c3

        # θ: flux-form with contravariant transport
        theta = state.rho_theta / state.rho
        theta_pad = fl.pad(theta, g, fl.CCC)
        jrho_pad = fl.pad(state.rho * jac_c3, g, fl.CCC)
        G_rho_theta = -adv.div_rho_u_c(
            so, model.scalar_advection, jrho_pad, u_pad, v_pad, wt_pad,
            theta_pad) / jac_c3

        # momentum advection: Cartesian velocities advected by the
        # J-weighted horizontal + contravariant vertical mass fluxes
        w_cart = state.rho_w / (0.5 * (so.v(rho_pad1) + so.v(rho_pad1, dz=-1)))
        adv_u, adv_v, adv_w = adv.momentum_flux_divergence(
            so, model.momentum_advection, jru_pad, jrv_pad, rwt_pad,
            u_pad, v_pad, fl.pad(w_cart, g, fl.FCC))
        adv_u = adv_u / jac_xf3
        adv_v = adv_v / jac_yf3
        adv_w = adv_w / jac_c3

        cor_x, cor_y, cor_z = coriolis_terms(
            model.coriolis, so, rho_u_pad, rho_v_pad,
            fl.pad(state.rho_w, g, fl.FCC), g)

        # PGF + buoyancy in perturbation form against the 3-D reference
        p = eos_pressure(model, state.rho_theta)
        p_pert_pad = fl.pad(p - terrain.p_ref, g, fl.CCC)
        dpdx, dpdy, dpdz_f = terrain_pressure_gradients(terrain, so, p_pert_pad)
        rho_pert = state.rho - terrain.rho_ref
        rp_pad = fl.pad(rho_pert, g, fl.CCC)
        buoy_f = -g_acc * so.iz_cf(rp_pad)

        G_rho_u = -adv_u - cor_x - dpdx
        G_rho_v = -adv_v - cor_y - dpdy
        G_rho_w = -adv_w - cor_z - dpdz_f + buoy_f

        if g.is_latlon:
            from .compressible import latlon_curvature_terms
            du_m, dv_m = latlon_curvature_terms(g, so, state, u_pad, v_pad,
                                                rho_u_pad)
            G_rho_u = G_rho_u + du_m
            G_rho_v = G_rho_v + dv_m

        def sub(cur, init, G):
            return (1 - alpha) * init + alpha * (cur + dt * G)

        new_ru = sub(state.rho_u, s0.rho_u, G_rho_u)
        new_rv = sub(state.rho_v, s0.rho_v, G_rho_v)
        new_rw = sub(state.rho_w, s0.rho_w, G_rho_w)
        new_rho = sub(state.rho, s0.rho, G_rho)
        new_rt = sub(state.rho_theta, s0.rho_theta, G_rho_theta)

        # kinematic bottom: ρw(face 0) from the slope condition
        new_rw = new_rw.at[0].set(kinematic_bottom_rho_w(
            terrain, so, new_ru, new_rv))

        state = state.replace(rho=new_rho, rho_u=new_ru, rho_v=new_rv,
                              rho_w=new_rw, rho_theta=new_rt)

    return state.replace(time=state.time + dt)


def terrain_slow_tendencies(model: CompressibleModel, terrain: TerrainMetrics,
                            state: CompressibleState, aux):
    """Stage-entry slow tendencies over terrain for the split-explicit core.

    σ-coordinate counterpart of ``compressible.slow_tendencies`` (reference
    ``terrain_compressible_physics.jl:486-659`` slow dispatch): J-weighted
    flux-form advection with contravariant vertical transport, Coriolis,
    the FROZEN slope-corrected horizontal PGF of the full stage pressure,
    and the vertical stage-entry imbalance −(1/J)∂ζ(p−p_ref) − g·ℑ(ρ−ρ_ref)
    against the terrain's 3-D hydrostatic reference.

    Closures are applied through the flat-coordinate machinery (metric
    terms in the SGS fluxes neglected — a documented small-slope
    approximation; the resolved dynamics carry the full metric).
    """
    from ..dynamics.compressible import SlowTendencies, _RefShim
    from .. import advection as adv
    from ..physics.coriolis import coriolis_terms

    g = model.grid
    so = model.stencil_ops()
    g_acc = model.constants.gravitational_acceleration

    jac_c3 = terrain.jac_c3
    jac_xf3 = terrain.jac_xf3
    jac_yf3 = terrain.jac_yf3
    inv_jac_c3 = 1.0 / jac_c3

    rho_u_pad = fl.pad(state.rho_u, g, fl.CCF)
    rho_v_pad = fl.pad(state.rho_v, g, fl.CFC)
    rho_w_tilde = contravariant_rho_w(terrain, so, rho_u_pad, rho_v_pad,
                                      state.rho_w)
    rho_w_tilde = rho_w_tilde.at[0].set(0.0)
    rwt_pad = fl.pad(rho_w_tilde, g, fl.FCC)

    # reconstruction velocities: Cartesian horizontal, contravariant vertical
    rho_pad1 = fl.pad(state.rho, g, fl.CCC)
    wt = rho_w_tilde / (0.5 * (so.v(rho_pad1) + so.v(rho_pad1, dz=-1)))
    u_pad = fl.pad(aux.u, g, fl.CCF)
    v_pad = fl.pad(aux.v, g, fl.CFC)
    wt_pad = fl.pad(wt, g, fl.FCC)
    w_pad = fl.pad(aux.w, g, fl.FCC)

    jru_pad = fl.pad(state.rho_u * jac_xf3, g, fl.CCF)
    jrv_pad = fl.pad(state.rho_v * jac_yf3, g, fl.CFC)

    # mass: G_ρ = −(1/J)[δx(Jρu) + δy(Jρv) + δζ(ρw̃)]
    G_rho = -so.div_c(jru_pad, jrv_pad, rwt_pad) * inv_jac_c3

    # ρθ flux-form with contravariant transport
    theta_pad = fl.pad(aux.theta, g, fl.CCC)
    jrho_pad = fl.pad(state.rho * jac_c3, g, fl.CCC)
    G_rho_theta = -adv.div_rho_u_c(
        so, model.scalar_advection, jrho_pad, u_pad, v_pad, wt_pad,
        theta_pad) * inv_jac_c3

    # momentum advection with J-weighted mass fluxes
    adv_u, adv_v, adv_w = adv.momentum_flux_divergence(
        so, model.momentum_advection, jru_pad, jrv_pad, rwt_pad,
        u_pad, v_pad, w_pad)
    adv_u = adv_u / jac_xf3
    adv_v = adv_v / jac_yf3
    adv_w = adv_w * inv_jac_c3

    cor_x, cor_y, cor_z = coriolis_terms(
        model.coriolis, so, rho_u_pad, rho_v_pad,
        fl.pad(state.rho_w, g, fl.FCC), g)

    # frozen slope-corrected horizontal PGF + vertical stage-entry imbalance
    p_pert_pad = fl.pad(aux.p - terrain.p_ref, g, fl.CCC)
    dpdx, dpdy, dpdz_f = terrain_pressure_gradients(terrain, so, p_pert_pad)
    rho_pert = state.rho - terrain.rho_ref
    rp_pad = fl.pad(rho_pert, g, fl.CCC)
    imbalance = -dpdz_f - g_acc * so.iz_cf(rp_pad)

    G_rho_u = -adv_u - cor_x - dpdx
    G_rho_v = -adv_v - cor_y - dpdy
    G_rho_w = -adv_w - cor_z + imbalance

    if g.is_latlon:
        from .compressible import latlon_curvature_terms
        du_m, dv_m = latlon_curvature_terms(g, so, state, u_pad, v_pad,
                                            rho_u_pad)
        G_rho_u = G_rho_u + du_m
        G_rho_v = G_rho_v + dv_m

    G_rho_qt = (jnp.zeros_like(G_rho) if state.rho_qt is not None else None)

    nu_e = kappa_e = None
    if model.closure is not None:
        from ..physics.closures import ConstantDiffusivity, closure_tendencies

        class _AuxShim:
            def __init__(self, theta, qt):
                self.theta = theta
                self.qt = qt

        cf = closure_tendencies(
            _RefShim(model), so, _AuxShim(aux.theta, aux.qt),
            u_pad, v_pad, w_pad, rho=state.rho)
        G_rho_u = G_rho_u + cf.G_u
        G_rho_v = G_rho_v + cf.G_v
        G_rho_w = G_rho_w + cf.G_w
        G_rho_theta = G_rho_theta + cf.G_theta
        if G_rho_qt is not None and cf.G_qt is not None:
            G_rho_qt = G_rho_qt + cf.G_qt
        if getattr(model.closure, "vertically_implicit", False):
            nu_e = cf.nu_e
            kappa_e = (jnp.full(g.shape, model.closure.diffusivity, g.dtype)
                       if isinstance(model.closure, ConstantDiffusivity)
                       else nu_e / model.closure.prandtl)

    G = SlowTendencies(rho=G_rho, rho_u=G_rho_u, rho_v=G_rho_v,
                       rho_w=G_rho_w, rho_theta=G_rho_theta,
                       rho_qt=G_rho_qt, nu_e=nu_e, kappa_e=kappa_e)
    for forcing in model.forcings:
        G = forcing(model, state, aux, G)
    return G


def terrain_initial_state(model: CompressibleModel, terrain: TerrainMetrics,
                          theta=None, u=None) -> CompressibleState:
    """Initialize over terrain from the 3-D reference (+ optional θ, u).

    θ may be a callable of the TRUE height z (and x, y); density starts at
    the terrain-aware hydrostatic reference (pressure-balanced for θ
    perturbations via ρ = ρ_ref θ_ref/θ).
    """
    g = model.grid
    dt = g.dtype
    x, _, _ = g.xyz_c()
    z_true = terrain.z_true_c
    y = jnp.asarray(g.y_c(), dt)[None, :, None]

    theta_ref = model.reference.theta_col * jnp.ones(g.shape, dt)
    if theta is None:
        theta_arr = theta_ref
    else:
        theta_arr = jnp.asarray(theta(x, y, z_true), dt) * jnp.ones(g.shape, dt)

    rho_arr = terrain.rho_ref * theta_ref / theta_arr

    u_arr = (jnp.asarray(u(x, y, z_true), dt) * jnp.ones(g.shape, dt)
             if callable(u) else jnp.full(g.shape, 0.0 if u is None else u, dt))

    so = model.stencil_ops()
    rho_pad1 = fl.pad(rho_arr, g, fl.CCC)
    rho_xf = 0.5 * (so.v(rho_pad1) + so.v(rho_pad1, dx=-1))
    rho_u = rho_xf * u_arr
    rho_v = jnp.zeros(g.shape, dt)
    rho_w = jnp.zeros(g.shape, dt)
    rho_w = rho_w.at[0].set(kinematic_bottom_rho_w(terrain, so, rho_u, rho_v))

    return CompressibleState(
        rho=rho_arr, rho_u=rho_u, rho_v=rho_v, rho_w=rho_w,
        rho_theta=rho_arr * theta_arr, rho_qt=None, tracers={},
        time=jnp.zeros((), dt))
