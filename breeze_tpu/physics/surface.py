"""Surface boundary fluxes: prescribed fluxes and bulk formulae.

Equivalent of reference ``src/BoundaryConditions/`` (BulkDrag
``bulk_drag.jl:5-181``, bulk sensible-heat/vapor fluxes
``bulk_scalar_fluxes.jl:8-302``) and of the flux-BC tendency pathway
(``compute_flux_bc_tendencies!``, ``update_atmosphere_model_state.jl:418-434``):
a surface flux F through the bottom wall becomes a tendency ``+F/Δz`` on the
wall-adjacent cell (sign: downward-positive input flux increases the cell).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Monin–Obukhov stability machinery (reference
# ``polynomial_bulk_coefficient.jl:16-556``): Li et al. (2010) non-iterative
# Riᴮ → ζ mapping + Hogström (1996) / Beljaars & Holtslag (1991) integrated
# Ψ functions.  All published regression/fit constants.  Everything is
# branch-free ``jnp.where`` — one fused pass over the 2-D surface plane.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StabilityFunctionParameters:
    """Ψ-function constants (Hogström 1996 unstable; Beljaars & Holtslag
    1991 stable).  Reference ``StabilityFunctionParameters``."""

    gamma_d: float = 19.3
    gamma_t: float = 11.6
    a: float = 1.0
    b: float = 2.0 / 3.0
    c: float = 5.0
    d: float = 0.35


@dataclasses.dataclass(frozen=True)
class RichardsonNumberMapping:
    """Li et al. (2010) regression coefficients mapping bulk Richardson
    number Riᴮ to ζ = z/L (three regimes).  Reference
    ``RichardsonNumberMapping`` defaults."""

    stable_unstable_transition: float = 0.0
    strongly_stable_transition: float = 0.2
    # Unstable (Eq. 12)
    au11: float = 0.0450
    bu11: float = 0.0030
    bu12: float = 0.0059
    au21: float = -0.0828
    au22: float = 0.8845
    bu31: float = 0.1739
    bu32: float = -0.9213
    bu33: float = -0.1057
    # Weakly stable (Eq. 14)
    aw11: float = 0.5738
    aw12: float = -0.4399
    aw21: float = -4.901
    aw22: float = 52.50
    bw11: float = -0.0539
    bw12: float = 1.540
    bw21: float = -0.6690
    bw22: float = -3.282
    # Strongly stable (Eq. 16)
    as11: float = 0.7529
    as21: float = 14.94
    bs11: float = 0.1569
    bs21: float = -0.3091
    bs22: float = -1.303


@dataclasses.dataclass(frozen=True)
class FittedStabilityFunction:
    """MOST stability correction via the Li et al. (2010) analytic
    Riᴮ → ζ mapping (reference ``FittedStabilityFunction``).

    - Momentum: Cᴰ = Cᴰ_N · [α/(α − Ψᴰ)]²
    - Scalar:   Cᵀ = Cᵀ_N · [α/(α − Ψᴰ)] · [βₕ/(βₕ − Ψᵀ)]

    with α = ln(z/ℓ), βₕ = ln(z/ℓₕ).
    """

    scalar_roughness_length: float
    mapping: RichardsonNumberMapping = RichardsonNumberMapping()
    params: StabilityFunctionParameters = StabilityFunctionParameters()

    def zeta(self, Ri_b, alpha, beta):
        """Branch-free 3-regime Riᴮ → ζ (reference
        ``bulk_to_flux_richardson_number``)."""
        m = self.mapping
        # Unstable (Eq. 12)
        A_u = m.au11 * alpha
        B_u = ((m.bu11 * beta + m.bu12) * alpha ** 2
               + (m.au21 * beta + m.au22) * alpha
               + (m.bu31 * beta ** 2 + m.bu32 * beta + m.bu33))
        z_u = A_u * Ri_b ** 2 + B_u * Ri_b
        # Weakly stable (Eq. 14)
        A_w = (m.aw11 * beta + m.aw12) * alpha + (m.aw21 * beta + m.aw22)
        B_w = (m.bw11 * beta + m.bw12) * alpha + (m.bw21 * beta + m.bw22)
        z_w = A_w * Ri_b ** 2 + B_w * Ri_b
        # Strongly stable (Eq. 16)
        z_s = ((m.as11 * alpha + m.as21) * Ri_b
               + m.bs11 * alpha + m.bs21 * beta + m.bs22)
        return jnp.where(
            Ri_b < m.stable_unstable_transition, z_u,
            jnp.where(Ri_b <= m.strongly_stable_transition, z_w, z_s))

    def psi_momentum(self, zeta):
        """Ψᴰ(ζ): Hogström (1996) unstable / Beljaars–Holtslag (1991)
        stable (reference ``integrated_stability_momentum``)."""
        p = self.params
        x = jnp.sqrt(jnp.sqrt(jnp.maximum(1.0 - p.gamma_d * zeta, 0.0)))
        psi_un = (2.0 * jnp.log((1.0 + x) / 2.0)
                  + jnp.log((1.0 + x * x) / 2.0)
                  - 2.0 * jnp.arctan(x) + jnp.pi / 2.0)
        psi_st = -(p.a * zeta
                   + p.b * (zeta - p.c / p.d) * jnp.exp(-p.d * zeta)
                   + p.b * p.c / p.d)
        return jnp.where(zeta < 0.0, psi_un, psi_st)

    def psi_scalar(self, zeta):
        """Ψᵀ(ζ) (reference ``integrated_stability_scalar``)."""
        p = self.params
        y = jnp.sqrt(jnp.maximum(1.0 - p.gamma_t * zeta, 0.0))
        psi_un = 2.0 * jnp.log((1.0 + y) / 2.0)
        xs = jnp.maximum(1.0 + 2.0 * p.a / 3.0 * zeta, 0.0)
        psi_st = -(xs * jnp.sqrt(xs)
                   + p.b * (zeta - p.c / p.d) * jnp.exp(-p.d * zeta)
                   + p.b * p.c / p.d - 1.0)
        return jnp.where(zeta < 0.0, psi_un, psi_st)

    def correction(self, Ri_b, alpha, beta, transfer: str):
        """Stability correction factor multiplying the neutral coefficient
        (reference ``stability_correction_factor``)."""
        zeta = self.zeta(Ri_b, alpha, beta)
        psi_d = self.psi_momentum(zeta)
        den_d = jnp.maximum(alpha - psi_d, alpha / 10.0)
        if transfer == "momentum":
            return (alpha / den_d) ** 2
        psi_t = self.psi_scalar(zeta)
        beta_h = alpha + beta
        den_t = jnp.maximum(beta_h - psi_t, beta_h / 10.0)
        return (alpha / den_d) * (beta_h / den_t)


#: Large & Yeager (2009) neutral 10-m polynomials (a₀, a₁, a₂)·1e-3,
#: reference ``default_neutral_*_polynomial``.
NEUTRAL_DRAG_POLYNOMIAL = (0.142, 0.076, 2.7)
NEUTRAL_SENSIBLE_HEAT_POLYNOMIAL = (0.128, 0.068, 2.43)
NEUTRAL_LATENT_HEAT_POLYNOMIAL = (0.120, 0.070, 2.55)


@dataclasses.dataclass(frozen=True)
class PolynomialCoefficient:
    """Wind- and stability-dependent bulk transfer coefficient
    (Large & Yeager 2009 neutral polynomial + MOST stability correction),
    reference ``PolynomialCoefficient`` (``polynomial_bulk_coefficient.jl``).

    ``C_N¹⁰(U) = (a₀ + a₁U + a₂/U)·10⁻³`` at 10 m, log-profile adjusted to
    the evaluation height, times the :class:`FittedStabilityFunction`
    correction from the bulk Richardson number.  ``polynomial=None`` picks
    the per-slot Large & Yeager default (drag/sensible/latent) at
    evaluation time.  ``stability_function``: ``"fitted"`` (default) builds
    a :class:`FittedStabilityFunction` with ℓₕ = ℓ/7.3 (ocean); ``None``
    disables the correction; or pass an instance.
    """

    polynomial: tuple | None = None
    roughness_length: float = 1.5e-4
    minimum_wind_speed: float = 0.1
    stability_function: object = "fitted"

    def resolved_stability_function(self):
        if self.stability_function == "fitted":
            return FittedStabilityFunction(self.roughness_length / 7.3)
        return self.stability_function

    def neutral_10m(self, U, polynomial=None):
        """C_N¹⁰(U) (reference ``neutral_coefficient_10m``)."""
        a0, a1, a2 = polynomial or self.polynomial
        U_safe = jnp.maximum(U, self.minimum_wind_speed)
        return (a0 + a1 * U_safe + a2 / U_safe) * 1e-3

    def __call__(self, U, h, Ri_b=None, transfer="momentum",
                 default_polynomial=NEUTRAL_DRAG_POLYNOMIAL):
        poly = self.polynomial or default_polynomial
        C10 = self.neutral_10m(U, poly)
        ell = self.roughness_length
        alpha = math.log(h / ell)
        Ch = C10 * (math.log(10.0 / ell) / alpha) ** 2
        sf = self.resolved_stability_function()
        if sf is None or Ri_b is None:
            return Ch * jnp.ones_like(U)
        beta = math.log(ell / sf.scalar_roughness_length)
        return Ch * sf.correction(Ri_b, alpha, beta, transfer)


@dataclasses.dataclass(frozen=True)
class WindDependentCoefficient:
    """Piecewise-linear wind-dependent transfer coefficient
    ``C(|U|) = min(a + b·|U|, c_max)`` — the Reed & Jablonowski (2011)
    "simple physics" surface drag (DCMIP2016; the reference validation
    study's ``WindDependentDrag`` dispatching ``bulk_coefficient``).

    No stability correction (wind-only, like the reference's
    ``filtered_θᵥ_source(::WindDependentDrag) = nothing`` path).
    Defaults are the RJ drag constants: Cᴰ = min(7e-4 + 6.5e-5|U|, 2e-3).
    """

    a: float = 7.0e-4
    b: float = 6.5e-5
    c_max: float = 2.0e-3

    def __call__(self, U):
        return jnp.minimum(self.a + self.b * U, self.c_max)


def bulk_richardson_number(h, thv, thv0, U, U_min, g=9.81):
    """Riᴮ = (g/θ̄ᵥ)·h·(θᵥ − θᵥ₀)/U² (reference
    ``bulk_richardson_number``)."""
    U_safe = jnp.maximum(U, U_min)
    thv_mean = 0.5 * (thv + thv0)
    return (g / thv_mean) * h * (thv - thv0) / U_safe ** 2


# ---------------------------------------------------------------------------
# Filtered surface state (reference ``filtered_surface_state.jl:25-344``):
# exponential temporal filtering of the near-surface matching state,
# mitigating spurious u*–u′ correlations in wall-modeled LES (Nishizawa &
# Kitamura 2018; Shin, Yang & Howland 2025).  Functional redesign: the
# filtered 2-D planes live in ``state.diagnostics`` (non-advected stepwise
# storage) and are advanced once per outer step,
#     x̄ ← (x̄ + ε xⁿ)/(1 + ε),   ε = Δt/τ.
# ---------------------------------------------------------------------------

SURFACE_FILTER_KEYS = ("sf_u", "sf_v", "sf_thv", "sf_theta", "sf_qt")


@dataclasses.dataclass(frozen=True)
class SurfaceFilter:
    """Config for filtered bulk-flux inputs (reference
    ``FilteredSurfaceVelocities``/``FilteredSurfaceScalar``).

    - ``height``: evaluation height for u, v (None → first cell center;
      a number → linear interpolation to that height).  θᵥ/θ/qᵗ are always
      read at the first cell center, as in the reference.
    - ``filter_timescale``: τ [s]; ``inf`` (default) freezes the filter at
      its initialization value (no filtering).
    """

    height: float | None = None
    filter_timescale: float = math.inf


def _height_weights(grid, height):
    """Static (k, w) pair for linear interpolation of a center field to
    ``height``: value = (1−w)·f[k] + w·f[k+1]."""
    import numpy as np
    # grid.z_c is a tracer under jit; the static z_c_meta tuple carries the
    # same heights as compile-time Python floats.
    z_c = np.asarray(grid.z_c_meta if grid.z_c_meta else grid.z_c)
    if height is None or height <= z_c[0]:
        return 0, 0.0
    k = int(np.searchsorted(z_c, height) - 1)
    k = min(max(k, 0), len(z_c) - 2)
    w = float((height - z_c[k]) / (z_c[k + 1] - z_c[k]))
    return k, min(max(w, 0.0), 1.0)


def surface_layer_values(model, aux, height=None):
    """Instantaneous near-surface matching values (2-D planes):
    u, v at ``height``; θᵥ, θ, qᵗ at the first cell center."""
    k, w = _height_weights(model.grid, height)
    u1 = (1.0 - w) * aux.u[k] + w * aux.u[k + 1] if w > 0.0 else aux.u[0]
    v1 = (1.0 - w) * aux.v[k] + w * aux.v[k + 1] if w > 0.0 else aux.v[0]
    c = model.constants
    delta = c.Rv / c.Rd - 1.0
    theta1 = aux.theta[0]
    if aux.qt is not None:
        qv1 = aux.q.vapor[0]
        thv1 = theta1 * (1.0 + delta * qv1 - aux.q.liquid[0] - aux.q.ice[0])
        qt1 = aux.qt[0]
    else:
        thv1 = theta1
        qt1 = jnp.zeros_like(theta1)
    return {"sf_u": u1, "sf_v": v1, "sf_thv": thv1,
            "sf_theta": theta1, "sf_qt": qt1}


def _diagnose_any(model, state):
    from ..dynamics.compressible import CompressibleModel, compressible_diagnose
    if isinstance(model, CompressibleModel):
        return compressible_diagnose(model, state)
    from ..model import diagnose
    return diagnose(model, state)


def initialize_surface_filter(model, state):
    """Allocate + initialize the filtered planes in ``state.diagnostics``
    (reference ``initialize_filtered_surface_state!``)."""
    bf = model.boundary_fluxes
    filt = getattr(bf, "filter", None)
    if filt is None:
        return state
    vals = surface_layer_values(model, _diagnose_any(model, state),
                                filt.height)
    return state.replace(diagnostics={**state.diagnostics, **vals})


def update_surface_filter(model, state, aux, dt):
    """One exponential-filter update, x̄ ← (x̄ + ε xⁿ)/(1+ε) (reference
    ``update_filtered_surface_state!``).  No-op for τ = inf."""
    bf = model.boundary_fluxes
    filt = getattr(bf, "filter", None)
    if filt is None or SURFACE_FILTER_KEYS[0] not in state.diagnostics:
        return state
    if math.isinf(filt.filter_timescale):
        return state
    eps = dt / filt.filter_timescale
    vals = surface_layer_values(model, aux, filt.height)
    diags = dict(state.diagnostics)
    for key, new in vals.items():
        diags[key] = (diags[key] + eps * new) / (1.0 + eps)
    return state.replace(diagnostics=diags)


@dataclasses.dataclass(frozen=True)
class PrescribedSurfaceFluxes:
    """Constant (or callable(time)) kinematic surface fluxes.

    - ``theta_flux``: w'θ' [K m/s]  (e.g. BOMEX: 8e-3)
    - ``qt_flux``:   w'qᵗ' [m/s]    (e.g. BOMEX: 5.2e-5)
    - ``momentum_drag_coefficient``: bulk Cd for u,v drag (None = free slip)
    - ``friction_velocity``: if set, drag uses u*² scaling instead of Cd|U|
    """

    theta_flux: float | Callable = 0.0
    qt_flux: float | Callable = 0.0
    momentum_drag_coefficient: float | None = None
    friction_velocity: float | None = None
    gustiness: float = 0.1


@dataclasses.dataclass(frozen=True)
class BulkSurfaceFluxes:
    """Bulk aerodynamic fluxes against prescribed surface values.

    F_θ = -Cθ |U| (θ₁ − θ_s),  F_q = -Cq |U| (q₁ − q_s(T_s)),
    τ = -Cd |U| u₁  (reference ``bulk_scalar_fluxes.jl:8-302``).

    Each transfer coefficient may be a constant float or a
    :class:`PolynomialCoefficient` (wind- and stability-dependent, Large &
    Yeager 2009 + Li et al. 2010 MOST — the reference's
    ``polynomial_bulk_coefficient.jl:16-556`` machinery, with per-slot
    default polynomials: drag/sensible/latent).

    For constant coefficients, ``stability_correction`` multiplies them by
    a Louis (1979)-type function of the bulk Richardson number — a cheaper
    branch-free proxy retained for backward compatibility.

    ``filter``: a :class:`SurfaceFilter` switches every bulk-formula input
    (wind, θᵥ, θ, qᵗ) to temporally filtered near-surface planes
    (reference ``filtered_surface_state.jl``).
    """

    surface_temperature: float = 300.0
    surface_theta: float | None = None
    surface_qt: float | None = None      # None -> saturated at Ts
    drag_coefficient: float | PolynomialCoefficient | \
        WindDependentCoefficient = 1.2e-3
    heat_transfer_coefficient: float | PolynomialCoefficient | \
        WindDependentCoefficient = 1.2e-3
    vapor_transfer_coefficient: float | PolynomialCoefficient | \
        WindDependentCoefficient = 1.2e-3
    gustiness: float = 0.1
    stability_correction: bool = False
    louis_b: float = 9.4
    louis_c_star: float = 7.4
    filter: SurfaceFilter | None = None

    def stability_factor(self, Ri_b):
        """Louis (1979) f(Ri_b): >1 unstable, <1 stable, =1 neutral."""
        b = self.louis_b
        cd = (self.drag_coefficient
              if not isinstance(self.drag_coefficient, PolynomialCoefficient)
              else 1.2e-3)
        c = self.louis_c_star * cd * b  # convective term
        unstable = 1.0 + b * jnp.abs(Ri_b) / (
            1.0 + c * jnp.sqrt(jnp.abs(Ri_b)))
        stable = 1.0 / (1.0 + 0.5 * b * jnp.maximum(Ri_b, 0.0)) ** 2
        return jnp.where(Ri_b < 0, unstable, stable)


def _value(v, t):
    return v(t) if callable(v) else v


def surface_flux_values(bf, model, state, aux, want_moisture: bool):
    """Kinematic surface fluxes through the bottom wall (shared by the
    anelastic and compressible paths).

    Returns ``(F_theta, F_qt, F_u, F_v)``: w'θ' [K m/s], w'qᵗ' [m/s], and
    the kinematic momentum fluxes −τₓ/ρ, −τᵧ/ρ [m²/s²] (``None`` entries
    mean no flux of that quantity).  Tendencies follow as ``+ρ₀F/Δz₀`` on
    the wall-adjacent cells (reference ``compute_flux_bc_tendencies!``,
    ``update_atmosphere_model_state.jl:418-434``).
    """
    g = model.grid
    ref = model.reference
    u1 = aux.u[0]
    v1 = aux.v[0]
    speed = jnp.sqrt(u1 * u1 + v1 * v1 + getattr(bf, "gustiness", 0.1) ** 2)

    if isinstance(bf, PrescribedSurfaceFluxes):
        th_flux = _value(bf.theta_flux, state.time)
        qt_flux = _value(bf.qt_flux, state.time) if want_moisture else None
        F_u = F_v = None
        if bf.friction_velocity is not None:
            ustar2 = bf.friction_velocity ** 2
            F_u = -ustar2 * u1 / speed
            F_v = -ustar2 * v1 / speed
        elif bf.momentum_drag_coefficient is not None:
            cd = bf.momentum_drag_coefficient
            F_u = -cd * speed * u1
            F_v = -cd * speed * v1
        return th_flux, qt_flux, F_u, F_v

    if isinstance(bf, BulkSurfaceFluxes):
        from ..thermo.saturation import saturation_specific_humidity
        from ..thermo.states import theta_li_from_temperature
        from ..thermo.constants import MoistureMassFractions

        c = model.constants

        # Matching state: filtered planes when configured (reference
        # filtered_surface_state.jl), instantaneous first-cell otherwise.
        use_filter = (bf.filter is not None
                      and SURFACE_FILTER_KEYS[0] in state.diagnostics)
        if use_filter:
            d = state.diagnostics
            u1, v1 = d["sf_u"], d["sf_v"]
            theta1, qt1, thv1 = d["sf_theta"], d["sf_qt"], d["sf_thv"]
            speed = jnp.sqrt(u1 * u1 + v1 * v1 + bf.gustiness ** 2)
        else:
            vals = surface_layer_values(model, aux)
            theta1, qt1, thv1 = (vals["sf_theta"], vals["sf_qt"],
                                 vals["sf_thv"])

        theta_s = bf.surface_theta
        if theta_s is None:
            q0 = MoistureMassFractions(0.0, 0.0, 0.0)
            theta_s = theta_li_from_temperature(
                jnp.asarray(bf.surface_temperature, g.dtype), q0,
                ref.surface_pressure, c, model.p_standard)

        q_s = bf.surface_qt
        if q_s is None:
            rho_surf = ref.surface_pressure / (c.Rd * bf.surface_temperature)
            q_s = saturation_specific_humidity(
                jnp.asarray(bf.surface_temperature, g.dtype), rho_surf, c)

        # Bulk Richardson number from VIRTUAL potential temperatures
        # (reference polynomial_bulk_coefficient.jl:
        # surface_virtual_potential_temperature + bulk_richardson_number).
        z_c0 = g.z_c_meta[0] if g.z_c_meta else float(g.z_c[0])
        h = z_c0 if getattr(bf.filter, "height", None) is None \
            else float(bf.filter.height)
        delta = c.Rv / c.Rd - 1.0
        thv0 = bf.surface_temperature * (1.0 + delta * q_s)
        Ri_b = bulk_richardson_number(
            h, thv1, thv0, speed, 0.1, c.gravitational_acceleration)

        def coeff(slot, transfer, default_poly):
            if isinstance(slot, PolynomialCoefficient):
                return slot(speed, h, Ri_b, transfer, default_poly)
            if isinstance(slot, WindDependentCoefficient):
                return slot(speed)
            stab = 1.0
            if bf.stability_correction:
                stab = bf.stability_factor(jnp.clip(Ri_b, -10.0, 10.0))
            return slot * stab

        c_th = coeff(bf.heat_transfer_coefficient, "scalar",
                     NEUTRAL_SENSIBLE_HEAT_POLYNOMIAL)
        th_flux = -c_th * speed * (theta1 - theta_s)

        qt_flux = None
        if want_moisture and aux.qt is not None:
            c_q = coeff(bf.vapor_transfer_coefficient, "scalar",
                        NEUTRAL_LATENT_HEAT_POLYNOMIAL)
            qt_flux = -c_q * speed * (qt1 - q_s)

        cd = coeff(bf.drag_coefficient, "momentum", NEUTRAL_DRAG_POLYNOMIAL)
        return th_flux, qt_flux, -cd * speed * u1, -cd * speed * v1

    raise TypeError(f"unknown boundary flux config {bf!r}")


def apply_boundary_flux_tendencies(model, state, aux, G):
    """Add surface-flux tendencies to the bottom-cell rows of G (anelastic)."""
    bf = model.boundary_fluxes
    g = model.grid
    dz0 = g.dz_c[0]
    rho0 = model.reference.rho_c[0]

    th_flux, qt_flux, F_u, F_v = surface_flux_values(
        bf, model, state, aux, want_moisture=G.rho_qt is not None)

    if th_flux is not None:
        G = G.replace(rho_theta=G.rho_theta.at[0].add(rho0 * th_flux / dz0))
    if qt_flux is not None and G.rho_qt is not None:
        G = G.replace(rho_qt=G.rho_qt.at[0].add(rho0 * qt_flux / dz0))
    if F_u is not None:
        G = G.replace(
            rho_u=G.rho_u.at[0].add(rho0 * F_u / dz0),
            rho_v=G.rho_v.at[0].add(rho0 * F_v / dz0))
    return G
