"""One-moment 4-category bulk microphysics (cloud liquid / cloud ice / rain /
snow) with CloudMicrophysics.jl-parity process rates.

Equivalent of the reference's 1M extension
(``ext/BreezeCloudMicrophysicsExt/one_moment_microphysics.jl:1101-1292``
mixed-phase tendency bundle + thermodynamics-dependent translations
``cloud_microphysics_translations.jl:50-397``).  The reference imports the
process rates from CloudMicrophysics.jl; here the same published closed-form
gamma-integral rates (CliMA 1-moment scheme; Kaul et al. 2015 lineage) are
implemented directly, vectorized over the grid:

- Marshall-Palmer / Kaul exponential size distributions ``n(r) = n₀e^{-λr}``
  with power-law mass/area/velocity laws ``x(r) = χₓ x₀ (r/r₀)^{xe+Δx}``.
- Condensation/deposition: Morrison & Grabowski (2008) relaxation with the
  thermodynamic adjustment factor Γ = 1 + (ℒ/cᵖᵐ)·dq⁺/dT
  (reference ``src/Microphysics/bulk_microphysics.jl:117-176``).
- Collection: closed-form collision integrals (accretion, rain sink by ice,
  rain-snow) with CloudMicrophysics default efficiencies.
- Ventilated rain evaporation / snow sublimation-deposition / snow melting
  (Mason equation + ventilation factor), cloud-ice melting, warm-accretion
  melt factor, supersaturation ice→snow autoconversion.

The parameter values are the published CloudMicrophysics.jl defaults (see
each dataclass).  Structural departure: the reference computes tendencies
inside the RK loop per-cell; here the scheme is applied operator-split once
per outer step under a fixed-count ``lax.fori_loop`` sedimentation subcycle
(same pattern as :mod:`breeze_tpu.physics.kessler`), with forward-Euler
process updates per substep.  Cloud-condensate sedimentation uses Stokes fall
speeds (the reference uses Chen et al. 2022 for small ice — a documented
deviation; magnitudes are cm/s either way).

Prognostics: vapor (the model moisture slot ``rho_qt``) + tracers
``rho_qcl, rho_qci, rho_qr, rho_qs`` (warm-phase option: liquid + rain only).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from ..thermo.constants import MoistureMassFractions
from ..thermo.saturation import saturation_specific_humidity, supersaturation
from ..thermo.states import temperature_from_theta_li

GAMMA = math.gamma

#: numerical floor below which a category is treated as absent (reference
#: CloudMicrophysics ``ϵ_numerics``).
Q_EPS = 1e-10


# ---------------------------------------------------------------------------
# Particle parameter containers (CloudMicrophysics.jl 1M defaults)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AirProperties:
    """CloudMicrophysics ``AirProperties`` defaults."""

    nu_air: float = 1.6e-5       # kinematic viscosity [m^2/s]
    D_vapor: float = 2.26e-5     # vapor diffusivity [m^2/s]
    K_therm: float = 2.4e-2      # thermal conductivity [J/m/s/K]


@dataclasses.dataclass(frozen=True)
class ParticleMass:
    """m(r) = χₘ m₀ (r/r₀)^{me+Δm}."""

    r0: float
    m0: float
    me: float
    dm: float = 0.0
    chm: float = 1.0


@dataclasses.dataclass(frozen=True)
class ParticleArea:
    """a(r) = χₐ a₀ (r/r₀)^{ae+Δa}."""

    a0: float
    ae: float
    da: float = 0.0
    cha: float = 1.0


@dataclasses.dataclass(frozen=True)
class Ventilation:
    """F = a + b·Sc^{1/3}·Re^{1/2} ventilation coefficients."""

    a: float
    b: float


@dataclasses.dataclass(frozen=True)
class RainParams:
    """CloudMicrophysics ``Rain`` + ``Blk1MVelTypeRain`` defaults.

    v(r) = χᵥ v₀ (r/r₀)^{ve+Δv} with v₀ = √[(8/3/C_d)(ρʷ/ρ − 1) g r₀]
    (hydrodynamic drag balance), n₀ = 16·10⁶ m⁻⁴ (Marshall-Palmer).
    """

    n0: float = 1.6e7
    rho_w: float = 1.0e3
    mass: ParticleMass = ParticleMass(
        r0=1e-3, m0=4.0 / 3.0 * math.pi * 1.0e3 * 1e-9, me=3.0)
    area: ParticleArea = ParticleArea(a0=math.pi * 1e-6, ae=2.0)
    vent: Ventilation = Ventilation(a=1.5, b=0.53)
    C_drag: float = 0.55
    ve: float = 0.5
    dv: float = 0.0
    chv: float = 1.0

    def n0_of(self, q, rho):
        return self.n0

    def v0_of(self, rho, grav):
        return jnp.sqrt(8.0 / (3.0 * self.C_drag)
                        * (self.rho_w / rho - 1.0) * grav * self.mass.r0)


@dataclasses.dataclass(frozen=True)
class SnowParams:
    """CloudMicrophysics ``Snow`` + ``Blk1MVelTypeSnow`` defaults.

    m(r) = 0.1 r² kg, a(r) = 0.3π r², v(r) = 2^{9/4} r^{1/4},
    n₀(q, ρ) = μ (ρ q/ρ₀)^ν with μ = 4.36·10⁹ m⁻⁴, ν = 0.63
    (Kaul et al. 2015).
    """

    mu: float = 4.36e9
    nu: float = 0.63
    rho0: float = 1.0
    mass: ParticleMass = ParticleMass(r0=1e-3, m0=1e-1 * 1e-6, me=2.0)
    area: ParticleArea = ParticleArea(a0=0.3 * math.pi * 1e-6, ae=2.0)
    vent: Ventilation = Ventilation(a=0.65, b=0.44)
    v0: float = 2.0 ** 2.25 * (1e-3) ** 0.25
    ve: float = 0.25
    dv: float = 0.0
    chv: float = 1.0

    def n0_of(self, q, rho):
        return self.mu * jnp.maximum(rho * q / self.rho0, 0.0) ** self.nu

    def v0_of(self, rho, grav):
        return self.v0


@dataclasses.dataclass(frozen=True)
class CloudIceParams:
    """CloudMicrophysics ``CloudIce`` defaults: ρᵢ = 916.7 kg/m³,
    r₀ = 10 μm, m(r) = (4π/3)ρᵢ r³, n₀ = 2·10⁷ m⁻⁴."""

    rho_i: float = 916.7
    n0: float = 2.0e7
    r_eff: float = 25e-6   # effective radius for Stokes sedimentation
    mass: ParticleMass = ParticleMass(
        r0=1e-5, m0=4.0 / 3.0 * math.pi * 916.7 * 1e-15, me=3.0)

    def n0_of(self, q, rho):
        return self.n0


@dataclasses.dataclass(frozen=True)
class CloudLiquidParams:
    """Cloud droplet bulk properties (ρʷ, effective radius for Stokes
    sedimentation of suspended droplets)."""

    rho_w: float = 1.0e3
    r_eff: float = 14e-6


# ---------------------------------------------------------------------------
# Size-distribution helpers (CloudMicrophysics.Microphysics1M)
# ---------------------------------------------------------------------------

def lambda_inverse(params, q, rho):
    """λ⁻¹ of the exponential DSD from the mass closure:

    ρq = ∫ m(r) n₀e^{-λr} dr = χₘ m₀ n₀ Γ(me+Δm+1) λ^{-(me+Δm+1)} / r₀^{me+Δm}

    Returns 0 where the category is (numerically) absent.
    """
    m = params.mass
    p = m.me + m.dm + 1.0
    n0 = params.n0_of(q, rho)
    qp = jnp.maximum(q, Q_EPS)
    num = rho * qp * m.r0 ** (m.me + m.dm)
    den = jnp.maximum(m.chm * m.m0 * n0 * GAMMA(p), 1e-300)
    lam_inv = (num / den) ** (1.0 / p)
    return jnp.where(q > Q_EPS, lam_inv, 0.0)


def terminal_velocity(params, q, rho, grav):
    """Mass-weighted Blk1M terminal velocity (group fall speed):

    v_t = χᵥ v₀ (λ⁻¹/r₀)^{ve+Δv} · Γ(me+Δm+ve+Δv+1)/Γ(me+Δm+1)
    """
    m = params.mass
    lam_inv = lambda_inverse(params, q, rho)
    v0 = params.v0_of(rho, grav)
    e = params.ve + params.dv
    me_t = m.me + m.dm
    vt = (params.chv * v0 * (lam_inv / m.r0) ** e
          * GAMMA(me_t + e + 1.0) / GAMMA(me_t + 1.0))
    return jnp.where(q > Q_EPS, vt, 0.0)


def stokes_terminal_velocity(rho_particle, r_eff, rho, nu_air, grav):
    """Stokes-regime fall speed v = (2/9)(ρₚ − ρ) g r²/μ for suspended
    cloud condensate (μ = ρ·ν)."""
    return (2.0 / 9.0) * (rho_particle - rho) * grav * r_eff ** 2 / (
        rho * nu_air)


# ---------------------------------------------------------------------------
# Thermodynamic factors (reference cloud_microphysics_translations.jl:50-67,
# src/Microphysics/bulk_microphysics.jl:117-176)
# ---------------------------------------------------------------------------

def diffusional_growth_factor(air, T, c, ice=False):
    """G factor of the Mason droplet-growth equation, Eq. (13.28) of
    Pruppacher & Klett (2010)."""
    Rv = c.Rv
    if ice:
        L = c.ice_latent_heat(T)
        pvs = _svp(T, c, lam=0.0)
    else:
        L = c.liquid_latent_heat(T)
        pvs = _svp(T, c, lam=1.0)
    return 1.0 / (L / (air.K_therm * T) * (L / (Rv * T) - 1.0)
                  + Rv * T / (air.D_vapor * pvs))


def _svp(T, c, lam):
    from ..thermo.saturation import saturation_vapor_pressure
    return saturation_vapor_pressure(T, c, lam)


def thermodynamic_adjustment_factor(qvs, T, q, c, ice=False):
    """Γ = 1 + (ℒ/cᵖᵐ)·dq⁺/dT with dq⁺/dT = q⁺(ℒ/RᵛT² − 1/T)."""
    L = c.ice_latent_heat(T) if ice else c.liquid_latent_heat(T)
    cpm = c.mixture_heat_capacity(q)
    dqdT = qvs * (L / (c.Rv * T ** 2) - 1.0 / T)
    return 1.0 + (L / cpm) * dqdT


def condensation_rate(qv, qvs, qcl, T, q, tau, c, min_timescale=0.0):
    """MG2008 relaxation condensation, evaporation limited by available
    cloud liquid (reference ``bulk_microphysics.jl:147-156``).

    ``min_timescale`` floors the effective timescale (used by the
    operator-split integrator to keep the forward-Euler substep stable when
    Δt_sub > Γτ; the reference integrates the same rate inside RK3 at small
    Δt and needs no floor).
    """
    Gamma = thermodynamic_adjustment_factor(qvs, T, q, c)
    timescale = jnp.maximum(Gamma * tau, min_timescale)
    S = (qv - qvs) / timescale
    return jnp.maximum(S, -jnp.maximum(qcl, 0.0) / timescale)


def deposition_rate(qv, qvsi, qci, T, q, tau, c, min_timescale=0.0):
    """Ice analogue of :func:`condensation_rate`."""
    Gamma = thermodynamic_adjustment_factor(qvsi, T, q, c, ice=True)
    timescale = jnp.maximum(Gamma * tau, min_timescale)
    S = (qv - qvsi) / timescale
    return jnp.maximum(S, -jnp.maximum(qci, 0.0) / timescale)


def temperature_dependent_ice_relaxation_timescale(ci: CloudIceParams,
                                                   air: AirProperties,
                                                   qci, T, T_freeze):
    """Deposition timescale from the Frostenberg-sampled Fletcher INP
    concentration (reference ``cloud_microphysics_translations.jl:78-96``)."""
    Tc = jnp.minimum(T - T_freeze, 0.0)
    Nci = jnp.exp(9.0 * jnp.log(jnp.maximum(-Tc, 1e-6) / 10.0))
    r = jnp.maximum(
        jnp.where(Nci > Q_EPS,
                  jnp.cbrt(3.0 * jnp.maximum(qci, 0.0)
                           / (4.0 * math.pi * jnp.maximum(Nci, Q_EPS)
                              * ci.rho_i)),
                  0.0),
        1e-6)
    return 1.0 / (4.0 * math.pi * air.D_vapor * Nci * r)


# ---------------------------------------------------------------------------
# Collection (collision-integral) rates
# ---------------------------------------------------------------------------

def accretion(cloud_q, precip_q, rho, E, precip, grav):
    """Accretion of suspended cloud condensate by falling precipitation:

    S = qᶜ E ∫ a(r)v(r) n(r) dr
      = qᶜ E n₀ a₀ v₀ χₐχᵥ Γ(σ+1) λ⁻¹^{σ+1} / r₀^σ,  σ = ae+Δa+ve+Δv
    """
    a = precip.area
    r0 = precip.mass.r0
    sig = a.ae + a.da + precip.ve + precip.dv
    n0 = precip.n0_of(precip_q, rho)
    v0 = precip.v0_of(rho, grav)
    lam_inv = lambda_inverse(precip, precip_q, rho)
    S = (cloud_q * E * n0 * a.a0 * v0 * a.cha * precip.chv
         * GAMMA(sig + 1.0) * lam_inv ** (sig + 1.0) / r0 ** sig)
    return jnp.where((cloud_q > Q_EPS) & (precip_q > Q_EPS), S, 0.0)


def accretion_rain_sink(qci, qr, rho, E, ice: CloudIceParams,
                        rain: RainParams, grav):
    """Rain mass sink from collisions with cloud ice (forms snow):

    S = E n₀ⁱ n₀ʳ χₘχₐχᵥ m₀a₀v₀ Γ(σ+1) λᵢ⁻¹ λʳ⁻¹^{σ+1} / (ρ r₀^σ),
    σ = me+Δm+ae+Δa+ve+Δv (all of rain's).
    """
    m, a = rain.mass, rain.area
    sig = m.me + m.dm + a.ae + a.da + rain.ve + rain.dv
    lam_i_inv = lambda_inverse(ice, qci, rho)
    lam_r_inv = lambda_inverse(rain, qr, rho)
    n0_i = ice.n0_of(qci, rho)
    n0_r = rain.n0_of(qr, rho)
    v0 = rain.v0_of(rho, grav)
    S = (E * n0_i * n0_r * m.chm * m.m0 * a.cha * a.a0 * rain.chv * v0
         * GAMMA(sig + 1.0) * lam_i_inv * lam_r_inv ** (sig + 1.0)
         / (rho * m.r0 ** sig))
    return jnp.where((qci > Q_EPS) & (qr > Q_EPS), S, 0.0)


def accretion_between_precip(collector, collected, q_i, q_j, rho, E,
                             velocity_dispersion, grav):
    """Collection of species j by species i among precipitating categories
    (rain-snow), from the geometric-sweep-out collision integral with
    π(rᵢ+rⱼ)² cross-section expanded over both exponential DSDs:

    S = π E n₀ᵢ n₀ʲ m₀ʲχₘʲ |Δv| / (ρ r₀ʲ^{mσ}) ·
        [2Γ(mσ+1) λᵢ⁻¹³ λⱼ⁻¹^{mσ+1} + 2Γ(mσ+2) λᵢ⁻¹² λⱼ⁻¹^{mσ+2}
         + Γ(mσ+3) λᵢ⁻¹ λⱼ⁻¹^{mσ+3}],   mσ = meʲ+Δmʲ

    (the rᵢ², 2rᵢrⱼ, rⱼ² pieces of the π(rᵢ+rⱼ)² cross-section)

    with |Δv| ≈ √[(v_tᵢ−v_tⱼ)² + d·v_tᵢ v_tⱼ] (Ikawa & Saito 1991
    dispersion closure, d = ``velocity_dispersion``).
    """
    mj = collected.mass
    msig = mj.me + mj.dm
    lam_i_inv = lambda_inverse(collector, q_i, rho)
    lam_j_inv = lambda_inverse(collected, q_j, rho)
    n0_i = collector.n0_of(q_i, rho)
    n0_j = collected.n0_of(q_j, rho)
    vti = terminal_velocity(collector, q_i, rho, grav)
    vtj = terminal_velocity(collected, q_j, rho, grav)
    dv = jnp.sqrt((vti - vtj) ** 2 + velocity_dispersion * vti * vtj)
    bracket = (2.0 * GAMMA(msig + 1.0) * lam_i_inv ** 3
               * lam_j_inv ** (msig + 1.0)
               + 2.0 * GAMMA(msig + 2.0) * lam_i_inv ** 2
               * lam_j_inv ** (msig + 2.0)
               + GAMMA(msig + 3.0) * lam_i_inv
               * lam_j_inv ** (msig + 3.0))
    S = (math.pi * E * n0_i * n0_j * mj.chm * mj.m0 * dv * bracket
         / (rho * mj.r0 ** msig))
    return jnp.where((q_i > Q_EPS) & (q_j > Q_EPS), S, 0.0)


# ---------------------------------------------------------------------------
# Ventilated diffusional rates (reference translations :179-358)
# ---------------------------------------------------------------------------

def _ventilation_factor(params, q, rho, air, grav):
    """F = aᵥ + bᵥ Sc^{1/3} √Re (λ⁻¹/r₀)^{(ve+Δv)/2} Γ((ve+Δv+5)/2),
    Re = 2 v₀χᵥ λ⁻¹/ν — the DSD-integrated ventilation correction."""
    v = params.vent
    e = params.ve + params.dv
    lam_inv = lambda_inverse(params, q, rho)
    v0 = params.v0_of(rho, grav)
    Sc = air.nu_air / max(air.D_vapor, 1e-300)
    Re = 2.0 * v0 * params.chv / air.nu_air * lam_inv
    size = (lam_inv / params.mass.r0) ** (e / 2.0)
    gamma_vent = GAMMA(e / 2.0 + 2.5)
    return v.a + v.b * jnp.cbrt(Sc) * jnp.sqrt(jnp.maximum(Re, 0.0)) \
        * size * gamma_vent


def rain_evaporation(rain, air, q, qr, rho, T, c, grav):
    """Ventilated rain evaporation (Mason equation over the DSD); only the
    evaporative (negative) branch is physical for rain."""
    S = supersaturation(T, rho, q, c, 1.0)
    G = diffusional_growth_factor(air, T, c)
    n0 = rain.n0_of(qr, rho)
    lam_inv = lambda_inverse(rain, qr, rho)
    base = 4.0 * math.pi * n0 / rho * S * G * lam_inv ** 2
    rate = base * _ventilation_factor(rain, qr, rho, air, grav)
    evaporating = (qr > Q_EPS) & (S < 0.0)
    return jnp.where(evaporating, jnp.minimum(rate, 0.0), 0.0)


def snow_sublimation_deposition(snow, air, q, qs, rho, T, c, grav):
    """Ventilated snow sublimation (𝒮ⁱ<0) / deposition (𝒮ⁱ>0)."""
    S = supersaturation(T, rho, q, c, 0.0)
    G = diffusional_growth_factor(air, T, c, ice=True)
    n0 = snow.n0_of(qs, rho)
    lam_inv = lambda_inverse(snow, qs, rho)
    base = 4.0 * math.pi * n0 / rho * S * G * lam_inv ** 2
    rate = base * _ventilation_factor(snow, qs, rho, air, grav)
    return jnp.where(qs > Q_EPS, rate, 0.0)


def snow_melting(snow, air, qs, rho, T, T_freeze, c, grav):
    """Sensible-heat-driven ventilated snow melting (T > Tᶠ),
    non-negative."""
    Lf = c.ice_latent_heat(T) - c.liquid_latent_heat(T)
    n0 = snow.n0_of(qs, rho)
    lam_inv = lambda_inverse(snow, qs, rho)
    base = (4.0 * math.pi * n0 / rho * air.K_therm / Lf
            * (T - T_freeze) * lam_inv ** 2)
    rate = base * _ventilation_factor(snow, qs, rho, air, grav)
    return jnp.where((qs > Q_EPS) & (T > T_freeze),
                     jnp.maximum(rate, 0.0), 0.0)


def cloud_ice_melting(ice, air, qci, rho, T, T_freeze, c):
    """Cloud-ice → cloud-liquid melting (unventilated)."""
    Lf = c.ice_latent_heat(T) - c.liquid_latent_heat(T)
    lam_inv = lambda_inverse(ice, qci, rho)
    rate = (4.0 * math.pi * ice.n0_of(qci, rho) / rho * air.K_therm / Lf
            * (T - T_freeze) * lam_inv ** 2)
    return jnp.where((qci > Q_EPS) & (T > T_freeze),
                     jnp.maximum(rate, 0.0), 0.0)


def ice_autoconversion_supersaturation(ice, air, q, qci, rho, T, T_freeze,
                                       r_ice_snow, c):
    """Supersaturation-driven ice→snow autoconversion: diffusional growth of
    crystals past r_is (reference translations :104-128)."""
    m = ice.mass
    S = supersaturation(T, rho, q, c, 0.0)
    G = diffusional_growth_factor(air, T, c, ice=True)
    lam_inv = jnp.maximum(lambda_inverse(ice, qci, rho), 1e-30)
    rate = (4.0 * math.pi * S * G * ice.n0_of(qci, rho) / rho
            * jnp.exp(-r_ice_snow / lam_inv)
            * (r_ice_snow ** 2 / (m.me + m.dm)
               + (r_ice_snow / lam_inv + 1.0) * lam_inv ** 2))
    active = (qci > Q_EPS) & (S > 0.0) & (T < T_freeze)
    return jnp.where(active, rate, 0.0)


def warm_accretion_melt_factor(T, T_freeze, c):
    """α = cˡ(T − Tᶠ)/ℒf: extra snow melted per unit warm accreted mass."""
    cl = c.liquid.heat_capacity
    Lf = c.ice_latent_heat(T) - c.liquid_latent_heat(T)
    return jnp.where(T <= T_freeze, 0.0, cl / Lf * (T - T_freeze))


# ---------------------------------------------------------------------------
# Scheme
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OneMomentMicrophysics:
    """CloudMicrophysics-parity 1M bulk scheme configuration.

    ``warm_phase=True`` gives the reference's WPNE1M (cloud liquid + rain
    only); the default is the mixed-phase MPNE1M 4-category scheme.
    """

    air: AirProperties = AirProperties()
    cloud_liquid: CloudLiquidParams = CloudLiquidParams()
    cloud_ice: CloudIceParams = CloudIceParams()
    rain: RainParams = RainParams()
    snow: SnowParams = SnowParams()
    # condensate formation (MG2008 relaxation timescales)
    tau_cond: float = 10.0
    tau_dep: float = 10.0
    temperature_dependent_ice_formation: bool = False
    # autoconversion (Acnv1M defaults)
    q_liq_threshold: float = 5e-4
    tau_acnv_liq: float = 1.0e3
    q_ice_threshold: float = 1e-6
    tau_acnv_ice: float = 1.0e2
    supersaturation_ice_autoconversion: bool = False
    r_ice_snow: float = 62.5e-6
    # collision efficiencies (CloudMicrophysics defaults)
    E_liquid_rain: float = 0.8
    E_liquid_snow: float = 0.1
    E_ice_rain: float = 1.0
    E_ice_snow: float = 0.1
    E_rain_snow: float = 1.0
    velocity_dispersion: float = 0.08
    freezing_temperature: float = 273.15
    tau_num: float = 10.0          # reference τⁿᵘᵐ numerical guard
    # phases / sedimentation
    warm_phase: bool = False
    sediment_cloud_condensate: bool = True
    substep_cfl: float = 0.8
    max_terminal_velocity: float = 10.0

    liquid_tracer_names = ("rho_qcl", "rho_qr")
    surface_diagnostic_names = ("surface_precip_rate", "accumulated_precip")
    # host-side sedimentation trip count is computed from dt
    requires_static_dt = True

    @property
    def prognostic_tracer_names(self):
        if self.warm_phase:
            return ("rho_qcl", "rho_qr")
        return ("rho_qcl", "rho_qci", "rho_qr", "rho_qs")

    @property
    def ice_tracer_names(self):
        return () if self.warm_phase else ("rho_qci", "rho_qs")

    @property
    def correction_tracer_chain(self):
        # heavy→light borrowing into vapor (reference
        # correction_moisture_fields, one_moment_microphysics.jl:535-536)
        if self.warm_phase:
            return ("rho_qr", "rho_qcl")
        return ("rho_qs", "rho_qr", "rho_qci", "rho_qcl")

    def model_update(self, model, state, dt: float):
        return one_moment_update(self, model, state, float(dt))


def _process_rates(scheme, qv, qcl, qci, qr, qs, rho, T, c, grav,
                   min_timescale=0.0):
    """All phase-change / collection rates of the reference MPNE1M bundle
    (``one_moment_microphysics.jl:1101-1292``), vectorized.  Returns the
    five conserved tendencies (dqv, dqcl, dqci, dqr, dqs) in
    mass-fraction/s.  ``min_timescale`` floors every relaxation/guard
    timescale (operator-split stability; see :func:`condensation_rate`)."""
    air = scheme.air
    Tf = scheme.freezing_temperature
    q = MoistureMassFractions(qv, qcl + qr, qci + qs)
    tau_num = max(scheme.tau_num, min_timescale)

    # --- condensation (vapor <-> cloud liquid), MG2008 ------------------
    qvs = saturation_specific_humidity(T, rho, c, 1.0)
    S_cond = condensation_rate(qv, qvs, qcl, T, q, scheme.tau_cond, c,
                               min_timescale)

    # --- deposition (vapor <-> cloud ice), warm-growth suppressed -------
    if not scheme.warm_phase:
        qvsi = saturation_specific_humidity(T, rho, c, 0.0)
        if scheme.temperature_dependent_ice_formation:
            tau_dep_eff = temperature_dependent_ice_relaxation_timescale(
                scheme.cloud_ice, air, qci, T, Tf)
            tau_ci = jnp.where(qv < qvsi, scheme.tau_dep, tau_dep_eff)
        else:
            tau_ci = scheme.tau_dep
        S_dep = deposition_rate(qv, qvsi, qci, T, q, tau_ci, c,
                                min_timescale)
        S_dep = jnp.where((T > Tf) & (S_dep > 0.0), 0.0, S_dep)
    else:
        S_dep = jnp.zeros_like(qv)

    # --- ventilated rain evaporation (negative) -------------------------
    S_evap = rain_evaporation(scheme.rain, air, q, qr, rho, T, c, grav)
    S_evap = jnp.maximum(S_evap, -jnp.maximum(qr, 0.0) / tau_num)

    # --- collection: liquid -> rain --------------------------------------
    S_acnv = jnp.maximum(0.0, qcl - scheme.q_liq_threshold) / scheme.tau_acnv_liq
    S_acc = accretion(qcl, qr, rho, scheme.E_liquid_rain, scheme.rain, grav)

    if scheme.warm_phase:
        dqv = -S_cond - S_evap
        dqcl = S_cond - S_acnv - S_acc
        dqr = S_acnv + S_acc + S_evap
        zero = jnp.zeros_like(qv)
        return dqv, dqcl, zero, dqr, zero

    # --- snow processes ---------------------------------------------------
    S_subl = snow_sublimation_deposition(scheme.snow, air, q, qs, rho, T,
                                         c, grav)
    S_subl = jnp.maximum(S_subl, -jnp.maximum(qs, 0.0) / tau_num)
    S_melt = snow_melting(scheme.snow, air, qs, rho, T, Tf, c, grav)
    S_melt = jnp.minimum(S_melt, jnp.maximum(qs, 0.0) / tau_num)
    S_melt_ci = cloud_ice_melting(scheme.cloud_ice, air, qci, rho, T, Tf, c)
    S_melt_ci = jnp.minimum(S_melt_ci, jnp.maximum(qci, 0.0) / tau_num)

    # --- ice -> snow autoconversion --------------------------------------
    if scheme.supersaturation_ice_autoconversion:
        S_acnv_is = ice_autoconversion_supersaturation(
            scheme.cloud_ice, air, q, qci, rho, T, Tf, scheme.r_ice_snow, c)
    else:
        S_acnv_is = (jnp.maximum(0.0, qci - scheme.q_ice_threshold)
                     / scheme.tau_acnv_ice)

    # --- mixed-phase accretions ------------------------------------------
    S_acc_ls = accretion(qcl, qs, rho, scheme.E_liquid_snow, scheme.snow,
                         grav)
    S_acc_is = accretion(qci, qs, rho, scheme.E_ice_snow, scheme.snow, grav)
    S_acc_ir = accretion(qci, qr, rho, scheme.E_ice_rain, scheme.rain, grav)
    S_acc_ri = accretion_rain_sink(qci, qr, rho, scheme.E_ice_rain,
                                   scheme.cloud_ice, scheme.rain, grav)
    # rain-snow collection both ways
    S_rs = accretion_between_precip(scheme.snow, scheme.rain, qs, qr, rho,
                                    scheme.E_rain_snow,
                                    scheme.velocity_dispersion, grav)
    S_sr = accretion_between_precip(scheme.rain, scheme.snow, qr, qs, rho,
                                    scheme.E_rain_snow,
                                    scheme.velocity_dispersion, grav)

    alpha = warm_accretion_melt_factor(T, Tf, c)
    is_warm = T >= Tf
    zero = jnp.zeros_like(qv)

    dqv = -S_cond - S_dep - S_evap - S_subl
    dqcl = S_cond - S_acnv - S_acc - S_acc_ls + S_melt_ci
    dqci = S_dep - S_acnv_is - S_acc_is - S_acc_ir - S_melt_ci
    dqr = (S_acnv + S_acc + S_evap - S_acc_ri + S_melt
           + jnp.where(is_warm,
                       S_acc_ls + alpha * S_acc_ls + S_sr + alpha * S_rs,
                       zero)
           - jnp.where(is_warm, zero, S_rs))
    dqs = (S_acnv_is + S_acc_is + S_acc_ir + S_acc_ri + S_subl - S_melt
           + jnp.where(is_warm, zero, S_acc_ls + S_rs)
           - jnp.where(is_warm, alpha * S_acc_ls + S_sr + alpha * S_rs,
                       zero))
    return dqv, dqcl, dqci, dqr, dqs


def one_moment_update(scheme: OneMomentMicrophysics, model, state, dt: float):
    """Operator-split 1M update (fixed-count subcycle for sedimentation).

    Anelastic states use the reference column (ρᵣ, pᵣ); compressible states
    (``state.rho``) use the true density and the fixed-partition θˡⁱ
    temperature inversion (same dispatch as the Kessler scheme).
    """
    g = model.grid
    c = model.constants
    ref = model.reference
    grav = c.gravitational_acceleration
    dz = g.dz_c_col

    rho_state = getattr(state, "rho", None)
    if rho_state is not None:
        from .microphysics import density_temperature_inversion
        rho = rho_state
        p = None  # T from the density inversion inside the loop
    else:
        rho = jnp.broadcast_to(ref.rho_col, g.shape).astype(g.dtype)
        p = jnp.broadcast_to(ref.p_col, g.shape).astype(g.dtype)

    zeros = jnp.zeros(g.shape, g.dtype)
    qv = jnp.maximum(state.rho_qt / rho, 0.0)
    qcl = jnp.maximum(state.tracers.get("rho_qcl", zeros) / rho, 0.0)
    qci = jnp.maximum(state.tracers.get("rho_qci", zeros) / rho, 0.0)
    qr = jnp.maximum(state.tracers.get("rho_qr", zeros) / rho, 0.0)
    qs = jnp.maximum(state.tracers.get("rho_qs", zeros) / rho, 0.0)
    theta = state.rho_theta / rho

    n_sub = max(1, math.ceil(dt * scheme.max_terminal_velocity
                             / (scheme.substep_cfl * g.dz_min)))
    dts = dt / n_sub

    def temperature_of(qv, ql, qi):
        q = MoistureMassFractions(qv, ql, qi)
        if p is not None:
            return temperature_from_theta_li(theta, q, p, c,
                                             model.p_standard)
        from .microphysics import density_temperature_inversion
        T, _p = density_temperature_inversion(theta, rho, q, c,
                                              model.p_standard)
        return T

    def settle(q1, W, precip_contrib):
        """Upwind sedimentation step; returns (new q, bottom flux kg/m²/s)."""
        W = jnp.minimum(W, scheme.max_terminal_velocity)
        flux = rho * q1 * W
        flux_above = jnp.concatenate([flux[1:], jnp.zeros_like(flux[:1])], 0)
        qn = jnp.maximum(q1 + dts * (flux_above - flux) / (rho * dz), 0.0)
        return qn, precip_contrib + flux[0]

    def subcycle(m, carry):
        qv, qcl, qci, qr, qs, precip = carry

        T = temperature_of(qv, qcl + qr, qci + qs)
        dqv, dqcl, dqci, dqr, dqs = _process_rates(
            scheme, qv, qcl, qci, qr, qs, rho, T, c, grav,
            min_timescale=dts)

        # Forward-Euler update with a CLOSED moisture budget: condensate
        # categories are clamped at zero and vapor absorbs the residual, so
        # the clamps can never create mass (the reference's per-tendency
        # numerical guards play this role inside RK3 at small Δt).
        qt0 = qv + qcl + qci + qr + qs
        qcl1 = jnp.maximum(qcl + dts * dqcl, 0.0)
        qci1 = jnp.maximum(qci + dts * dqci, 0.0)
        qr1 = jnp.maximum(qr + dts * dqr, 0.0)
        qs1 = jnp.maximum(qs + dts * dqs, 0.0)
        qv1 = jnp.maximum(qt0 - (qcl1 + qci1 + qr1 + qs1), 0.0)

        # --- sedimentation -------------------------------------------------
        Wr = terminal_velocity(scheme.rain, qr1, rho, grav)
        qr1, precip = settle(qr1, Wr, precip)
        if not scheme.warm_phase:
            Ws = terminal_velocity(scheme.snow, qs1, rho, grav)
            qs1, precip = settle(qs1, Ws, precip)
        if scheme.sediment_cloud_condensate:
            Wcl = stokes_terminal_velocity(scheme.cloud_liquid.rho_w,
                                           scheme.cloud_liquid.r_eff,
                                           rho, scheme.air.nu_air, grav)
            qcl1, precip = settle(qcl1, jnp.broadcast_to(Wcl, qcl1.shape),
                                  precip)
            if not scheme.warm_phase:
                Wci = stokes_terminal_velocity(scheme.cloud_ice.rho_i,
                                               scheme.cloud_ice.r_eff,
                                               rho, scheme.air.nu_air, grav)
                qci1, precip = settle(qci1,
                                      jnp.broadcast_to(Wci, qci1.shape),
                                      precip)

        # θˡⁱ is invariant under all phase changes by construction (the
        # diagnostic T = Πθˡⁱ + (ℒˡqˡ + ℒⁱqⁱ)/cᵖᵐ absorbs latent heating
        # through the composition change, melting via ℒⁱ−ℒˡ included).
        return qv1, qcl1, qci1, qr1, qs1, precip

    precip0 = jnp.zeros(g.shape[1:], g.dtype)
    qv, qcl, qci, qr, qs, precip = jax.lax.fori_loop(
        0, n_sub, subcycle, (qv, qcl, qci, qr, qs, precip0))

    tracers = dict(state.tracers)
    tracers["rho_qcl"] = rho * qcl
    tracers["rho_qr"] = rho * qr
    if not scheme.warm_phase:
        tracers["rho_qci"] = rho * qci
        tracers["rho_qs"] = rho * qs
    new_state = state.replace(rho_qt=rho * qv, tracers=tracers)

    # Surface precipitation diagnostics (reference
    # ``one_moment_helpers.jl:80-106``): mean bottom flux over the
    # subcycles [kg/m²/s] plus its running time integral [kg/m²].
    diag = dict(new_state.diagnostics)
    if "surface_precip_rate" in diag:
        rate = precip / n_sub
        diag["surface_precip_rate"] = rate
        diag["accumulated_precip"] = diag["accumulated_precip"] + dt * rate
        new_state = new_state.replace(diagnostics=diag)
    return new_state


def precipitation_production_rate(scheme: OneMomentMicrophysics, model,
                                  state):
    """Diagnostic: instantaneous cloud→rain production (autoconversion +
    accretion) [kg/kg/s] (reference ``one_moment_helpers.jl:35-60``)."""
    g = model.grid
    rho_state = getattr(state, "rho", None)
    rho = rho_state if rho_state is not None else jnp.broadcast_to(
        model.reference.rho_col, g.shape).astype(g.dtype)
    zeros = jnp.zeros(g.shape, g.dtype)
    qcl = jnp.maximum(state.tracers.get("rho_qcl", zeros) / rho, 0.0)
    qr = jnp.maximum(state.tracers.get("rho_qr", zeros) / rho, 0.0)
    S_acnv = jnp.maximum(0.0, qcl - scheme.q_liq_threshold) / scheme.tau_acnv_liq
    S_acc = accretion(qcl, qr, rho, scheme.E_liquid_rain, scheme.rain,
                      model.constants.gravitational_acceleration)
    return S_acnv + S_acc


def number_concentration(scheme: OneMomentMicrophysics, species, q, rho):
    """N = n₀·λ⁻¹ [1/m³] reconstructed from the scheme's DSD (reference
    ``one_moment_helpers.jl:118-152``)."""
    params = {"rain": scheme.rain, "snow": scheme.snow,
              "cloud_ice": scheme.cloud_ice}[species]
    qp = jnp.maximum(q, 0.0)
    return params.n0_of(qp, rho) * lambda_inverse(params, qp, rho)
