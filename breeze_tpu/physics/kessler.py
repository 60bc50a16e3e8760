"""DCMIP2016 Kessler warm-rain microphysics.

Equivalent of reference ``src/Microphysics/dcmip2016_kessler.jl``
(scheme :39-183, terminal velocity :396, production :420, core step :509-567,
column kernel :615-780).  The published DCMIP2016 Kessler physics
(Klemp & Wilhelmson 1978 coefficients) in mixing-ratio space.

Design departure from the reference: the reference launches one thread
per column with sequential k loops and a per-column adaptive sedimentation
subcycle.  Here everything is vectorized over the full grid — sedimentation
is an upwind shift along z, the subcycle is a ``lax.fori_loop`` with a
*global* fixed trip count (computed host-side from Δt and a terminal
velocity bound), and all process rates are fused elementwise arithmetic.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from ..thermo.constants import MoistureMassFractions
from ..thermo.saturation import saturation_specific_humidity


def _safe_pow(x, p):
    """``x**p`` (fractional p, x ≥ 0) with a zero-safe gradient.

    ``max(x,0)**p`` is the KW78 rate form, but its AD derivative at x = 0
    is ∞ for p < 1 (NaN in the backward pass).  Standard double-``where``:
    identical VALUES everywhere (0**p = 0 for p > 0), derivative clamped to
    0 at x = 0 — keeps jax.grad finite through the scheme (reference
    validates AD through its microphysics configs,
    ``test/reactant/weno_compilation_setup.jl:92-158``)."""
    safe = jnp.where(x > 0, x, 1.0)
    return jnp.where(x > 0, safe ** p, 0.0)


@dataclasses.dataclass(frozen=True)
class KesslerMicrophysics:
    """DCMIP2016 Kessler configuration (defaults = reference :154-168).

    Prognostics: vapor density (the model's moisture slot) + tracers
    ``rho_qcl`` (cloud liquid) and ``rho_qr`` (rain).
    Applied operator-split once per step (``microphysics_model_update!``).
    """

    dcmip_temperature_scale: float = 237.3
    terminal_velocity_coefficient: float = 36.34
    density_scale: float = 0.001
    terminal_velocity_exponent: float = 0.1364
    autoconversion_rate: float = 0.001
    autoconversion_threshold: float = 0.001
    accretion_rate: float = 2.2
    accretion_exponent: float = 0.875
    evaporation_ventilation_coefficient_1: float = 1.6
    evaporation_ventilation_coefficient_2: float = 124.9
    evaporation_ventilation_exponent_1: float = 0.2046
    evaporation_ventilation_exponent_2: float = 0.525
    diffusivity_coefficient: float = 2.55e8
    thermal_conductivity_coefficient: float = 5.4e5
    substep_cfl: float = 0.8
    max_terminal_velocity: float = 12.0   # bound used to fix the trip count
    # Tetens liquid coefficients used by the DCMIP saturation adjustment
    tetens_a: float = 17.27
    tetens_dT: float = 35.85

    # host-side sedimentation trip count is computed from dt
    requires_static_dt = True

    prognostic_tracer_names = ("rho_qcl", "rho_qr")
    liquid_tracer_names = ("rho_qcl", "rho_qr")
    ice_tracer_names = ()
    # reference correction_moisture_fields (one_moment_microphysics.jl:536):
    # rain borrows from cloud, cloud from vapor
    correction_tracer_chain = ("rho_qr", "rho_qcl")
    # surface-precipitation diagnostics (reference dcmip2016_kessler.jl:355-394)
    surface_diagnostic_names = ("surface_precip_rate", "accumulated_precip")

    # -- process rates (mixing-ratio space) ----------------------------
    def terminal_velocity(self, r_r, rho, rho_surf):
        """W = a (ρ rʳ Cᵨ)^β √(ρ₁/ρ)  (KW78 eq. 2.15, reference :396)."""
        a = self.terminal_velocity_coefficient
        return (a * _safe_pow(jnp.maximum(r_r * self.density_scale * rho, 0.0),
                              self.terminal_velocity_exponent)
                * jnp.sqrt(rho_surf / rho))

    def cloud_to_rain(self, r_cl, r_r, dt):
        """Implicit autoconversion + accretion (KW78 eq. 2.13, reference :420)."""
        A = jnp.maximum(0.0, self.autoconversion_rate
                        * (r_cl - self.autoconversion_threshold))
        denom = 1.0 + dt * self.accretion_rate * _safe_pow(
            jnp.maximum(r_r, 0.0), self.accretion_exponent)
        return r_cl - (r_cl - dt * A) / denom

    def model_update(self, model, state, dt: float):
        new_state, precip = kessler_update(self, model, state, float(dt))
        # Surface precipitation diagnostics (kinematic rate [m/s of
        # mass-fraction flux] and its time integral), when the state carries
        # the seeded diagnostics slots (reference dcmip2016_kessler.jl:355-394).
        diag = dict(new_state.diagnostics)
        if "surface_precip_rate" in diag:
            diag["surface_precip_rate"] = precip
            diag["accumulated_precip"] = (
                diag["accumulated_precip"] + float(dt) * precip)
            new_state = new_state.replace(diagnostics=diag)
        return new_state


def _mass_fractions_from_ratios(rv, rcl, rr):
    rt = rv + rcl + rr
    inv = 1.0 / (1.0 + rt)
    return rv * inv, rcl * inv, rr * inv


def _ratios_from_mass_fractions(qv, qcl, qr):
    qt = qv + qcl + qr
    inv = 1.0 / jnp.maximum(1.0 - qt, 1e-6)
    return qv * inv, qcl * inv, qr * inv


def _temperature_from_theta(theta_li, rv, rl, p, p_st, c):
    qv = rv / (1.0 + rv + rl)
    ql = rl / (1.0 + rv + rl)
    q = MoistureMassFractions(qv, ql, jnp.zeros_like(ql))
    cpm = c.mixture_heat_capacity(q)
    Rm = c.mixture_gas_constant(q)
    Pi = (p / p_st) ** (Rm / cpm)
    T = Pi * theta_li + c.liquid.reference_latent_heat * ql / cpm
    return T, Pi, cpm, Rm, ql


def kessler_update(scheme: KesslerMicrophysics, model, state, dt: float):
    """Operator-split Kessler update on the model state (whole grid at once).

    Anelastic: reference column (ρ = ρᵣ(z), p = pᵣ(z)).  Compressible
    states (``state.rho`` present): the TRUE density and the EOS pressure
    diagnosed by a fixed-partition θˡⁱ inversion at step entry (reference
    grid moisture fractions through ``LiquidIceDensityState``).  The
    moisture prognostic is vapor density ρqᵛ.
    """
    g = model.grid
    c = model.constants
    ref = model.reference
    p_st = model.p_standard
    dz = g.dz_c_col
    rho_surf = ref.rho_c[0]

    rho_state = getattr(state, "rho", None)
    if rho_state is not None:
        from .microphysics import density_temperature_inversion

        rho = rho_state
        zero = jnp.zeros(g.shape, g.dtype)
        qv0 = state.rho_qt / rho
        ql0 = (state.tracers.get("rho_qcl", zero)
               + state.tracers.get("rho_qr", zero)) / rho
        q0 = MoistureMassFractions(qv0, ql0, jnp.zeros_like(ql0))
        _T0, p = density_temperature_inversion(
            state.rho_theta / rho, rho, q0, c, p_st)
    else:
        rho = jnp.broadcast_to(ref.rho_col, g.shape).astype(g.dtype)
        p = jnp.broadcast_to(ref.p_col, g.shape).astype(g.dtype)

    Ll = c.liquid.reference_latent_heat
    cpd = c.dry_air.heat_capacity
    f5 = scheme.tetens_a * scheme.dcmip_temperature_scale * Ll / cpd
    dT_off = scheme.tetens_dT

    qv = jnp.maximum(state.rho_qt / rho, 0.0)
    qcl = jnp.maximum(state.tracers.get("rho_qcl", jnp.zeros_like(qv)) / rho, 0.0)
    qr = jnp.maximum(state.tracers.get("rho_qr", jnp.zeros_like(qv)) / rho, 0.0)
    theta = state.rho_theta / rho

    rv, rcl, rr = _ratios_from_mass_fractions(qv, qcl, qr)

    # Global fixed subcycle count from the terminal-velocity bound
    # (trace-friendly; reference uses per-column adaptive counts).
    dz_min = g.dz_min   # static metadata (jit-safe)
    n_sub = max(1, math.ceil(dt * scheme.max_terminal_velocity
                             / (scheme.substep_cfl * dz_min)))
    dts = dt / n_sub

    rho_k = scheme.density_scale * rho       # g/cm³-scaled density

    def subcycle(m, carry):
        rv, rcl, rr, theta, precip = carry

        W = scheme.terminal_velocity(rr, rho, rho_surf)

        # surface precipitation accumulation (mass-fraction × velocity)
        qr1 = rr[0] / (1.0 + rv[0] + rcl[0] + rr[0])
        precip = precip + qr1 * W[0]

        # Sedimentation: upwind (downward) flux divergence; zero inflow at top.
        flux = rho_k * rr * W
        flux_above = jnp.concatenate([flux[1:], jnp.zeros_like(flux[:1])], axis=0)
        dr_sed = dts * (flux_above - flux) / (rho_k * dz)

        # temperature from θˡⁱ
        T, Pi, cpm, Rm, ql = _temperature_from_theta(
            theta, rv, rcl + rr, p, p_st, c)

        # autoconversion + accretion
        drP = scheme.cloud_to_rain(rcl, rr, dts)
        rcl_1 = jnp.maximum(0.0, rcl - drP)
        rr_1 = jnp.maximum(0.0, rr + drP + dr_sed)

        # saturation mixing ratio (always over liquid)
        qvs = saturation_specific_humidity(T, rho, c, 1.0)
        rvs = qvs / (1.0 - qvs)

        # DCMIP saturation adjustment increment
        dr_sat = (rv - rvs) / (1.0 + rvs * f5 / (T - dT_off) ** 2)

        # rain evaporation (KW78 eq. 2.14)
        rho_rr = rho_k * rr_1
        Vev = ((scheme.evaporation_ventilation_coefficient_1
                + scheme.evaporation_ventilation_coefficient_2
                * _safe_pow(rho_rr, scheme.evaporation_ventilation_exponent_1))
               * _safe_pow(rho_rr, scheme.evaporation_ventilation_exponent_2))
        Dth = scheme.diffusivity_coefficient / (p * rvs) + scheme.thermal_conductivity_coefficient
        dr_vs = jnp.maximum(0.0, rvs - rv)
        E_r = Vev / Dth * dr_vs / (rho_k * rvs + 1e-20)
        dr_E_max = jnp.maximum(0.0, -dr_sat - rcl_1)
        dr_E = jnp.minimum(jnp.minimum(dts * E_r, dr_E_max), rr_1)

        # condensation limited by available cloud water
        dr_C = jnp.maximum(dr_sat, -rcl_1)
        rv_new = jnp.maximum(0.0, rv - dr_C + dr_E)
        rcl_new = rcl_1 + dr_C
        rr_new = rr_1 - dr_E
        dr_l = dr_C - dr_E

        # latent heating updates θˡⁱ at fixed p
        T_new = T + Ll / cpd * dr_l
        _, Pi2, cpm2, _, ql2 = _temperature_from_theta(
            jnp.zeros_like(theta), rv_new, rcl_new + rr_new, p, p_st, c)
        theta_new = (T_new - Ll * ql2 / cpm2) / Pi2

        return rv_new, rcl_new, rr_new, theta_new, precip

    precip0 = jnp.zeros_like(rv[0])
    rv, rcl, rr, theta, precip = jax.lax.fori_loop(
        0, n_sub, subcycle, (rv, rcl, rr, theta, precip0))

    qv_new, qcl_new, qr_new = _mass_fractions_from_ratios(rv, rcl, rr)
    tracers = dict(state.tracers)
    tracers["rho_qcl"] = rho * qcl_new
    tracers["rho_qr"] = rho * qr_new

    new_state = state.replace(
        rho_qt=rho * qv_new,
        rho_theta=rho * theta,
        tracers=tracers,
    )
    # mean surface precipitation rate over the subcycles (kinematic, m/s ×
    # mass fraction; multiply by ρ₁ for kg/m²/s)
    return new_state, precip / n_sub


# The time stepper expects model_update(model, state, dt) -> state;
# expose the precipitation as a stored diagnostic on request instead.
def kessler_model_update(scheme, model, state, dt):
    new_state, _ = kessler_update(scheme, model, state, dt)
    return new_state
