"""Subgrid-scale turbulence closures: Smagorinsky-Lilly (+ constant diffusivity).

Equivalent of the reference's closure substrate (Oceananigans
``SmagorinskyLilly``; density-weighting wrappers in
``src/TurbulenceClosures/TurbulenceClosures.jl:52-101``): the dynamic stress
is 𝒯 = ρ τ with kinematic τᵢⱼ = −2 νₑ Sᵢⱼ, scalar flux J = −ρ κₑ ∇c; the
momentum tendency gets −∂ⱼ𝒯ᵢⱼ and scalars −∇·J.

Everything is fused pointwise/stencil jnp on the staggered grid: strain
components live at their natural (center/corner) locations; νₑ at centers
with 4-point interpolation to corners.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import fields as fl
from ..ops import StencilOps


@dataclasses.dataclass(frozen=True)
class SmagorinskyLilly:
    """Smagorinsky (1963) with Lilly's stratification correction.

    νₑ = (C Δ)² √(2 SᵢⱼSᵢⱼ) ς,  ς² = max(0, 1 − N²/(Pr |S|²)),
    κₑ = νₑ / Pr.
    """

    coefficient: float = 0.16
    prandtl: float = 1.0 / 3.0
    buoyancy_correction: bool = True
    vertically_implicit: bool = False


@dataclasses.dataclass(frozen=True)
class AnisotropicMinimumDissipation:
    """Verstappen/Rozema anisotropic minimum dissipation (AMD) closure.

    Analogue of Oceananigans' ``AnisotropicMinimumDissipation``
    (reference ``src/Breeze.jl:219`` re-export):

        νₑ = C · max(0, −Σₖ Δₖ² (∂ₖuᵢ)(∂ₖuⱼ)Sᵢⱼ) / (∂ₗuₘ ∂ₗuₘ)

    with all gradients collocated at cell centers.
    """

    coefficient: float = 1.0 / 12.0
    prandtl: float = 1.0 / 3.0
    vertically_implicit: bool = False


@dataclasses.dataclass(frozen=True)
class DynamicSmagorinsky:
    """Germano-Lilly dynamic Smagorinsky (reference ``src/Breeze.jl:219``
    re-export of Oceananigans ``DynamicSmagorinsky``).

    The coefficient is computed from the resolved field via the Germano
    identity with a horizontal trapezoidal test filter of width αΔ:

        Lᵢⱼ = ⟨uᵢuⱼ⟩ₜ − ⟨uᵢ⟩ₜ⟨uⱼ⟩ₜ,
        Mᵢⱼ = 2Δ²(⟨|S|Sᵢⱼ⟩ₜ − α²|S̃|S̃ᵢⱼ),
        c² = ⟨LᵢⱼMᵢⱼ⟩ / ⟨MᵢⱼMᵢⱼ⟩   (averaged per level),
        νₑ = c² Δ² |S|.

    Redesign: everything is collocated at cell centers (one fused
    pass); the per-level averaging is a (y,x)-mean — the appropriate
    statistical homogenization for planar-homogeneous LES, clipped at
    c² ≥ 0.  Assumes periodic horizontal topologies for the test filter.
    """

    prandtl: float = 1.0 / 3.0
    test_filter_ratio: float = 2.0
    vertically_implicit: bool = False


@dataclasses.dataclass(frozen=True)
class ConstantDiffusivity:
    """Fixed kinematic viscosity/diffusivity (useful for tests)."""

    viscosity: float = 0.0
    diffusivity: float = 0.0
    vertically_implicit: bool = False


@dataclasses.dataclass(frozen=True)
class ReedJablonowskiBoundaryLayer:
    """Reed & Jablonowski (2012) wind-dependent boundary-layer mixing —
    component 2 of the DCMIP2016 "simple physics" (TC_PBL_mod = false;
    the reference validation study's ``rj_Km``/``rj_Ke`` kernel functions,
    ``validation/DCMIP2016_TC/dcmip2016_tc.jl``):

        Kₘ = Cᴰ(|v₁|)·|v₁|·zₐ·taper(p),   Kₑ = C·|v₁|·zₐ·taper(p),

    with Cᴰ = min(a + b|v₁|, c_max) the same wind-dependent surface drag,
    |v₁| the lowest-level wind speed, zₐ the lowest-level center height,
    and taper = 1 for p ≥ taper_pressure else
    exp(−((taper_pressure − p)/taper_scale)²).

    Vertical-only mixing, always applied through the implicit tridiagonal
    step (no explicit stress divergence — the horizontal SGS stresses are
    zero by definition of the scheme).
    """

    drag_a: float = 7.0e-4
    drag_b: float = 6.5e-5
    drag_max: float = 2.0e-3
    scalar_coefficient: float = 1.1e-3
    taper_pressure: float = 85000.0
    taper_scale: float = 10000.0
    vertically_implicit: bool = True


class ClosureFluxes(NamedTuple):
    G_u: jax.Array
    G_v: jax.Array
    G_w: jax.Array
    G_theta: jax.Array | None
    G_qt: jax.Array | None
    nu_e: jax.Array | None     # eddy viscosity at centers (diagnostic)
    kappa_e: jax.Array | None = None   # set when κₑ ≠ νₑ/Pr (e.g. RJ PBL)


def _corner_avg_xy(so, c_pad):
    """Center field → (yf, xf) corner via 4-point average."""
    return 0.25 * (so.v(c_pad) + so.v(c_pad, dx=-1)
                   + so.v(c_pad, dy=-1) + so.v(c_pad, dx=-1, dy=-1))


def _corner_avg_xz(so, c_pad):
    return 0.25 * (so.v(c_pad) + so.v(c_pad, dx=-1)
                   + so.v(c_pad, dz=-1) + so.v(c_pad, dx=-1, dz=-1))


def _corner_avg_yz(so, c_pad):
    return 0.25 * (so.v(c_pad) + so.v(c_pad, dy=-1)
                   + so.v(c_pad, dz=-1) + so.v(c_pad, dy=-1, dz=-1))


def _center_avg_from_xy_corner(so, q_pad):
    return 0.25 * (so.v(q_pad) + so.v(q_pad, dx=1)
                   + so.v(q_pad, dy=1) + so.v(q_pad, dx=1, dy=1))


def _center_velocity_gradients(g, so, u_pad, v_pad, w_pad):
    """All nine ∂ⱼuᵢ collocated at cell centers; ``grads[i][k] = ∂ₖuᵢ``."""

    def corner_to_center_xy(q):
        qp = fl.pad(q, g, (fl.C, fl.F, fl.F))
        return _center_avg_from_xy_corner(so, qp)

    def corner_to_center_xz(q):
        qp = fl.pad(q, g, (fl.F, fl.C, fl.F))
        return 0.25 * (so.v(qp) + so.v(qp, dx=1)
                       + so.v(qp, dz=1) + so.v(qp, dx=1, dz=1))

    def corner_to_center_yz(q):
        qp = fl.pad(q, g, (fl.F, fl.F, fl.C))
        return 0.25 * (so.v(qp) + so.v(qp, dy=1)
                       + so.v(qp, dz=1) + so.v(qp, dy=1, dz=1))

    du = (so.dx_fc(u_pad),
          corner_to_center_xy(so.dy_cf(u_pad)),
          corner_to_center_xz(so.dz_cf(u_pad)))
    dv = (corner_to_center_xy(so.dx_cf(v_pad)),
          so.dy_fc(v_pad),
          corner_to_center_yz(so.dz_cf(v_pad)))
    dw = (corner_to_center_xz(so.dx_cf(w_pad)),
          corner_to_center_yz(so.dy_cf(w_pad)),
          so.dz_fc(w_pad))
    return (du, dv, dw)


def closure_tendencies(model, so: StencilOps, aux, u_pad, v_pad, w_pad,
                       rho=None) -> ClosureFluxes:
    """Stress/flux divergences for the configured closure.

    ``rho``: optional TRUE 3-D density at centers (compressible path);
    when ``None`` the anelastic reference columns weight the stresses
    (reference ``TurbulenceClosures.jl:52-101`` ρ-weighting).
    """
    g = model.grid
    closure = model.closure
    ref = model.reference
    rho_c = ref.rho_col
    rho_f = ref.rho_f_col

    if isinstance(closure, ReedJablonowskiBoundaryLayer):
        # Vertical-only wind-dependent PBL diffusivities; no explicit
        # stresses — everything goes through the implicit vertical step.
        uc = so.ix_fc(u_pad)
        vc = so.iy_fc(v_pad)
        sp1 = jnp.sqrt(uc[0] ** 2 + vc[0] ** 2)        # (ny, nx)
        p3 = getattr(aux, "p", None)
        if p3 is None:                                  # anelastic: ref p(z)
            p3 = jnp.broadcast_to(ref.p_col, g.shape)
        z_a = g.z_c_meta[0] if g.z_c_meta else float(g.z_c[0])
        pt, ps = closure.taper_pressure, closure.taper_scale
        taper = jnp.where(p3 >= pt, 1.0,
                          jnp.exp(-((pt - p3) / ps) ** 2)).astype(g.dtype)
        cd = jnp.minimum(closure.drag_a + closure.drag_b * sp1,
                         closure.drag_max)
        Km = (cd * sp1 * z_a)[None] * taper
        Ke = (closure.scalar_coefficient * sp1 * z_a)[None] * taper
        zero = jnp.zeros(g.shape, g.dtype)
        return ClosureFluxes(
            G_u=zero, G_v=zero, G_w=zero, G_theta=zero,
            G_qt=zero if aux.qt is not None else None,
            nu_e=Km, kappa_e=Ke)

    # --- strain-rate tensor on the staggered grid ---------------------
    S11 = so.dx_fc(u_pad)                          # centers
    S22 = so.dy_fc(v_pad)
    S33 = so.dz_fc(w_pad)
    S12 = 0.5 * (so.dy_cf(u_pad) + so.dx_cf(v_pad))   # (zc, yf, xf)
    S13 = 0.5 * (so.dz_cf(u_pad) + so.dx_cf(w_pad))   # (zf, yc, xf)
    S23 = 0.5 * (so.dz_cf(v_pad) + so.dy_cf(w_pad))   # (zf, yf, xc)

    if isinstance(closure, ConstantDiffusivity):
        nu_c = jnp.full(g.shape, closure.viscosity, g.dtype)
        kappa_c = jnp.full(g.shape, closure.diffusivity, g.dtype)
    elif isinstance(closure, AnisotropicMinimumDissipation):
        grads = _center_velocity_gradients(g, so, u_pad, v_pad, w_pad)

        Sc = [[0.5 * (grads[i][j] + grads[j][i]) for j in range(3)]
              for i in range(3)]
        # grads index k: 0 = ∂x, 1 = ∂y, 2 = ∂z; directional Δₖ² weights
        deltas_sq = (g.dx ** 2, g.dy ** 2, g.dz_c_col ** 2)
        num = -sum(deltas_sq[k] * grads[i][k] * grads[j][k] * Sc[i][j]
                   for k in range(3) for i in range(3) for j in range(3))
        den = sum(grads[i][k] ** 2 for i in range(3) for k in range(3))
        nu_c = closure.coefficient * jnp.maximum(0.0, num) / jnp.maximum(den, 1e-20)
        kappa_c = nu_c / closure.prandtl
    elif isinstance(closure, DynamicSmagorinsky):
        # Germano-Lilly dynamic procedure, center-collocated (docstring).
        grads = _center_velocity_gradients(g, so, u_pad, v_pad, w_pad)
        Sc = [[0.5 * (grads[i][j] + grads[j][i]) for j in range(3)]
              for i in range(3)]
        S2c = 2.0 * sum(Sc[i][j] ** 2 for i in range(3) for j in range(3))
        absS = jnp.sqrt(S2c)
        uc = (so.ix_fc(u_pad), so.iy_fc(v_pad), so.iz_fc(w_pad))

        from ..parallel.halo import wrap_roll

        def tf(f):
            """Horizontal trapezoidal test filter (1/4, 1/2, 1/4)."""
            out = (0.25 * wrap_roll(f, 1, 2) + 0.5 * f
                   + 0.25 * wrap_roll(f, -1, 2))
            if g.ny > 1:
                out = (0.25 * wrap_roll(out, 1, 1) + 0.5 * out
                       + 0.25 * wrap_roll(out, -1, 1))
            return out

        u_f = [tf(ui) for ui in uc]
        S_f = [[tf(Sc[i][j]) for j in range(3)] for i in range(3)]
        absS_f = jnp.sqrt(
            2.0 * sum(S_f[i][j] ** 2 for i in range(3) for j in range(3)))
        delta = (g.dx * g.dy * jnp.asarray(g.dz_c)[:, None, None]) ** (1.0 / 3.0)
        alpha2 = closure.test_filter_ratio ** 2
        LM = jnp.zeros(g.shape, g.dtype)
        MM = jnp.zeros(g.shape, g.dtype)
        for i in range(3):
            for j in range(3):
                L_ij = tf(uc[i] * uc[j]) - u_f[i] * u_f[j]
                M_ij = 2.0 * delta ** 2 * (tf(absS * Sc[i][j])
                                           - alpha2 * absS_f * S_f[i][j])
                LM = LM + L_ij * M_ij
                MM = MM + M_ij * M_ij
        # per-level (y,x) statistical averaging, clipped at c² ≥ 0
        # (global under shard_map: pmean over the sharded mesh axes)
        from ..parallel.halo import _current_axes
        LM_bar = jnp.mean(LM, axis=(1, 2), keepdims=True)
        MM_bar = jnp.mean(MM, axis=(1, 2), keepdims=True)
        for _ax, _name in _current_axes().items():
            LM_bar = jax.lax.pmean(LM_bar, _name)
            MM_bar = jax.lax.pmean(MM_bar, _name)
        c2 = jnp.maximum(LM_bar / jnp.maximum(MM_bar, 1e-30), 0.0)
        nu_c = c2 * delta ** 2 * absS
        kappa_c = nu_c / closure.prandtl
    else:
        # |S|² at centers; off-diagonal components interpolated back.
        S12_pad = fl.pad(S12, g, (fl.C, fl.F, fl.F))
        S13_pad = fl.pad(S13, g, (fl.F, fl.C, fl.F))
        S23_pad = fl.pad(S23, g, (fl.F, fl.F, fl.C))
        S12c = 0.25 * (so.v(S12_pad) + so.v(S12_pad, dx=1)
                       + so.v(S12_pad, dy=1) + so.v(S12_pad, dx=1, dy=1))
        S13c = 0.25 * (so.v(S13_pad) + so.v(S13_pad, dx=1)
                       + so.v(S13_pad, dz=1) + so.v(S13_pad, dx=1, dz=1))
        S23c = 0.25 * (so.v(S23_pad) + so.v(S23_pad, dy=1)
                       + so.v(S23_pad, dz=1) + so.v(S23_pad, dy=1, dz=1))
        S2 = 2.0 * (S11**2 + S22**2 + S33**2
                    + 2.0 * (S12c**2 + S13c**2 + S23c**2))

        delta = (g.dx * g.dy * jnp.asarray(g.dz_c)[:, None, None]) ** (1.0 / 3.0)
        C = closure.coefficient
        abs_S = jnp.sqrt(S2)

        if closure.buoyancy_correction and aux.theta is not None:
            # N² = (g/θᵥ) ∂z θᵥ at centers, with θᵥ = θ(1 + δqᵛ − qᶜ) when
            # moisture fractions are available (falls back to θ(1 + δqᵗ)
            # from the total, then to dry θ).
            c = model.constants
            delta_rv = c.Rv / c.Rd - 1.0
            q = getattr(aux, "q", None)
            if q is not None:
                th_b = aux.theta * (1.0 + delta_rv * q.vapor
                                    - q.liquid - q.ice)
            elif getattr(aux, "qt", None) is not None:
                th_b = aux.theta * (1.0 + delta_rv * aux.qt)
            else:
                th_b = aux.theta
            th_pad = fl.pad(th_b, g, fl.CCC)
            dthdz_f = so.dz_cf(th_pad)
            dthdz = 0.5 * (dthdz_f + jnp.concatenate(
                [dthdz_f[1:], dthdz_f[-1:]], axis=0))
            g_acc = c.gravitational_acceleration
            N2 = g_acc / jnp.maximum(th_b, 1.0) * dthdz
            Ri = N2 / jnp.maximum(S2, 1e-20)
            zeta2 = jnp.maximum(0.0, 1.0 - Ri / closure.prandtl)
            abs_S = abs_S * jnp.sqrt(zeta2)

        nu_c = (C * delta) ** 2 * abs_S
        kappa_c = nu_c / closure.prandtl

    # --- dynamic stresses 𝒯ᵢⱼ = −2 ρ νₑ Sᵢⱼ --------------------------
    if rho is None:
        nu_pad = fl.pad(nu_c, g, fl.CCC)
        rho_nu_c = rho_c * nu_c
        rho_nu_xy = _corner_avg_xy(so, nu_pad) * rho_c    # ρ is z-only
        rho_nu_xz = _corner_avg_xz(so, nu_pad) * rho_f
        rho_nu_yz = _corner_avg_yz(so, nu_pad) * rho_f
    else:
        # true density: interpolate the PRODUCT ρνₑ to the stress locations
        rho_nu_c = rho * nu_c
        rnu_pad = fl.pad(rho_nu_c, g, fl.CCC)
        rho_nu_xy = _corner_avg_xy(so, rnu_pad)
        rho_nu_xz = _corner_avg_xz(so, rnu_pad)
        rho_nu_yz = _corner_avg_yz(so, rnu_pad)

    T11 = -2.0 * rho_nu_c * S11
    T22 = -2.0 * rho_nu_c * S22
    T33 = -2.0 * rho_nu_c * S33
    T12 = -2.0 * rho_nu_xy * S12
    T13 = -2.0 * rho_nu_xz * S13
    T23 = -2.0 * rho_nu_yz * S23

    # --- −∂ⱼ𝒯ᵢⱼ at each momentum location ---------------------------
    T11p = fl.pad(T11, g, fl.CCC)
    T22p = fl.pad(T22, g, fl.CCC)
    T33p = fl.pad(T33, g, fl.CCC)
    T12p = fl.pad(T12, g, (fl.C, fl.F, fl.F))
    T13p = fl.pad(T13, g, (fl.F, fl.C, fl.F))
    T23p = fl.pad(T23, g, (fl.F, fl.F, fl.C))

    # When the closure is vertically implicit, the vertical diffusive fluxes
    # of u, v, and scalars are EXCLUDED from the explicit tendency — the
    # tridiagonal implicit step applies them (mirrors Oceananigans
    # VerticallyImplicitTimeDiscretization semantics).
    vi = bool(getattr(closure, "vertically_implicit", False))
    G_u = -(so.dx_cf(T11p) + so.dy_fc(T12p)) - (0.0 if vi else so.dz_fc(T13p))
    G_v = -(so.dx_fc(T12p) + so.dy_cf(T22p)) - (0.0 if vi else so.dz_fc(T23p))
    G_w = -(so.dx_fc(T13p) + so.dy_fc(T23p) + so.dz_cf(T33p))

    # --- scalar diffusive flux divergences ---------------------------
    if rho is None:
        kappa_pad = fl.pad(kappa_c, g, fl.CCC)
        kw_x = kw_y = rho_c
        kw_z = rho_f
    else:
        kappa_pad = fl.pad(rho * kappa_c, g, fl.CCC)   # ρκ product
        kw_x = kw_y = kw_z = 1.0

    def scalar_diffusion(c):
        c_pad = fl.pad(c, g, fl.CCC)
        # J = -ρ κ ∇c at faces; G += −∇·J = ∇·(ρκ∇c)
        kx = 0.5 * (so.v(kappa_pad) + so.v(kappa_pad, dx=-1)) * kw_x
        ky = 0.5 * (so.v(kappa_pad) + so.v(kappa_pad, dy=-1)) * kw_y
        kz = 0.5 * (so.v(kappa_pad) + so.v(kappa_pad, dz=-1)) * kw_z
        Fx = kx * so.dx_cf(c_pad)
        Fy = ky * so.dy_cf(c_pad)
        Fz = kz * so.dz_cf(c_pad)
        if vi:
            Fz = jnp.zeros_like(Fz)   # vertical part handled implicitly
        # zero diffusive flux through walls
        Fz = Fz.at[0].set(0.0) if g.z_topology.value == "bounded" else Fz
        Fxp = fl.pad(Fx, g, fl.CCF)
        Fyp = fl.pad(Fy, g, fl.CFC)
        Fzp = fl.pad(Fz, g, fl.FCC)
        return so.div_c(Fxp, Fyp, Fzp)

    G_theta = scalar_diffusion(aux.theta)
    G_qt = scalar_diffusion(aux.qt) if aux.qt is not None else None

    return ClosureFluxes(G_u=G_u, G_v=G_v, G_w=G_w,
                         G_theta=G_theta, G_qt=G_qt, nu_e=nu_c)


def eddy_coefficients(model, state):
    """(νₑ, κₑ) at cell centers for the configured closure."""
    from ..model import diagnose

    g = model.grid
    closure = model.closure
    if isinstance(closure, ConstantDiffusivity):
        nu = jnp.full(g.shape, closure.viscosity, g.dtype)
        kappa = jnp.full(g.shape, closure.diffusivity, g.dtype)
        return nu, kappa
    aux = diagnose(model, state)
    so = model.stencil_ops()
    cf = closure_tendencies(model, so, aux,
                            fl.pad(aux.u, g, fl.CCF),
                            fl.pad(aux.v, g, fl.CFC),
                            fl.pad(aux.w, g, fl.FCC))
    if cf.kappa_e is not None:
        return cf.nu_e, cf.kappa_e
    return cf.nu_e, cf.nu_e / closure.prandtl


def implicit_vertical_diffusion_core(g, rho_c, rho_f, nu_c, kappa_c, dt_eff,
                                     new_ru, new_rv, new_rt, new_rq, new_tr):
    """Backward-Euler vertical diffusion via batched tridiagonal solve.

    Analogue of the reference's per-field ``implicit_step!`` with
    ``VerticallyImplicitTimeDiscretization`` (``ssp_runge_kutta_3.jl:139-160``):
    solve (ρc − Δt ∂z(ρ κ ∂z c))_new = (ρc)_rhs per column, z-walls
    zero-flux.  Removes the vertical diffusive CFL limit on stretched grids.
    ``rho_c``/``rho_f`` may be reference columns (anelastic) or true 3-D
    density fields (compressible ``implicit_substep!``,
    ``acoustic_runge_kutta_3.jl:151``).
    """
    from ..dynamics.tridiagonal import thomas_solve

    dz_c = g.dz_c_col
    dz_f = g.dz_f_col

    def solve(rho_field, coeff_c):
        # face coefficients: ρᶠ κᶠ at faces 1..nz-1 (0 at walls)
        coeff_f = 0.5 * (coeff_c + jnp.concatenate([coeff_c[:1], coeff_c[:-1]], 0))
        a_fac = rho_f * coeff_f / dz_f          # at faces 0..nz-1; face 0 wall→0
        a_fac = a_fac.at[0].set(0.0)
        a_up = jnp.concatenate([a_fac[1:], jnp.zeros_like(a_fac[:1])], 0)  # face k+1

        # row k (cell): ρᵣ c − Δt/Δzc [aᶠ(k+1)(c[k+1]−c[k]) − aᶠ(k)(c[k]−c[k−1])]
        lam = dt_eff / dz_c
        lower = -lam * a_fac
        upper = -lam * a_up
        diag = jnp.broadcast_to(rho_c, g.shape) + lam * (a_fac + a_up)
        c_spec = rho_field / rho_c
        rhs = jnp.broadcast_to(rho_c, g.shape) * c_spec
        c_new = thomas_solve(lower, diag, upper, rhs)
        return c_new * rho_c

    new_ru = solve(new_ru, nu_c)
    new_rv = solve(new_rv, nu_c)
    new_rt = solve(new_rt, kappa_c)
    if new_rq is not None:
        new_rq = solve(new_rq, kappa_c)
    new_tr = {k: solve(v, kappa_c) for k, v in new_tr.items()}
    return new_ru, new_rv, new_rt, new_rq, new_tr


def implicit_vertical_diffusion_step(model, state, new_ru, new_rv, new_rt,
                                     new_rq, new_tr, dt_eff):
    """Anelastic wrapper: reference-column densities + eddy coefficients
    from the pre-stage state."""
    ref = model.reference
    nu_c, kappa_c = eddy_coefficients(model, state)
    return implicit_vertical_diffusion_core(
        model.grid, ref.rho_col, ref.rho_f_col, nu_c, kappa_c, dt_eff,
        new_ru, new_rv, new_rt, new_rq, new_tr)
