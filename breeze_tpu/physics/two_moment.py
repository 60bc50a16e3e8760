"""Two-moment warm-rain microphysics (Seifert & Beheng 2006 family).

Analogue of the reference's 2M extension
(``ext/BreezeCloudMicrophysicsExt/two_moment_microphysics.jl:132-283`` +
κ-Köhler activation ``cloud_microphysics_translations.jl:592``): prognostic
cloud/rain mass AND number concentrations, Twomey-type aerosol activation,
SB2006 autoconversion/accretion/self-collection shapes, ventilated rain
evaporation, and mean-mass terminal velocities.  The process rates are the
published SB2006 set (the CloudMicrophysics.jl ``SB2006`` parameters the
reference delegates to): Eq. 4-6 autoconversion with the Φau universal
function, Eq. 5 cloud self-collection, Eq. 7-8 accretion with Φacc,
Eq. 9/13 rain self-collection + breakup, ventilated evaporation with the
incomplete-gamma number/mass integrals, and Rogers-form SB2006VelType
mass/number-weighted sedimentation — each pinned by rate tests against
hand-computed values (``tests/test_two_moment.py::TestSB2006RatePinning``).

Prognostics: vapor (model moisture slot) + tracers
``rho_qcl, rho_qr`` (mass densities) and ``rho_ncl, rho_nr`` (number
densities, 1/m³ × ρ-weighting kept analogous for conservative transport).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from ..thermo.saturation import (saturation_specific_humidity,
                                 saturation_vapor_pressure)
from ..thermo.constants import MoistureMassFractions
from ..thermo.states import temperature_from_theta_li


@dataclasses.dataclass(frozen=True)
class AerosolMode:
    """Lognormal κ-hygroscopicity aerosol mode (CloudMicrophysics
    ``Mode_κ``): ``N`` [1/m³], geometric-mean dry radius ``r_dry`` [m],
    geometric stdev, volume-weighted hygroscopicity κ (ammonium sulfate
    ≈ 0.53, sea salt ≈ 1.1)."""

    N: float = 100.0e6
    r_dry: float = 0.05e-6
    stdev: float = 2.0
    kappa: float = 0.53


@dataclasses.dataclass(frozen=True)
class AerosolActivation:
    """Abdul-Razzak & Ghan (2000) κ-Köhler aerosol activation.

    Translation of the reference's ``AerosolActivation`` +
    ``max_supersaturation_breeze`` (``cloud_microphysics_translations.jl:
    592-745``, activation tendencies ``two_moment_microphysics.jl:749-860``):
    per-mode critical supersaturation from κ-Köhler theory, the ARG
    maximum-supersaturation closure with Korolev & Mazin (2003) liquid
    phase-relaxation correction, lognormal activated fraction via erf, and
    a nucleation-timescale disequilibrium rate.  Deviation: the aerosol
    reservoir is a prescribed background (the mode ``N``s) rather than the
    reference's prognostic nᵃ tracer.

    ``f1/f2/g1/g2/p1/p2`` are the published ARG2000 fit constants
    (CloudMicrophysics ``AerosolActivationParameters`` defaults).
    """

    modes: tuple = (AerosolMode(),)
    surface_tension: float = 0.072      # σ [N/m]
    water_density: float = 1000.0       # ρ_w [kg/m³]
    f1: float = 0.5
    f2: float = 2.5
    g1: float = 1.0
    g2: float = 0.25
    p1: float = 1.5
    p2: float = 0.75
    nucleation_timescale: float = 1.0   # τⁿᵘᶜ [s]
    nucleation_radius: float = 5e-11    # fallback r when S ≈ 0 [m]
    max_activation_radius: float = 5e-6


def _mode_scrit(aa: AerosolActivation, mode: AerosolMode, A):
    """Critical supersaturation, ARG2000 eq. 9 (κ-Köhler form)."""
    kbar = max(mode.kappa, 1e-12)
    return (2.0 / math.sqrt(kbar)
            * jnp.sqrt(jnp.maximum(A / (3.0 * mode.r_dry), 0.0)) ** 3)


def arg_max_supersaturation(aa: AerosolActivation, air, rho, w, T, p, q,
                            ncl_vol, c):
    """Maximum supersaturation S_max (ARG2000 eq. 6 + Korolev-Mazin
    liquid relaxation), vectorized over the grid; returns ``(S_max, A)``
    with A the Kelvin curvature coefficient.  Warm phase (no ice terms)."""
    from .one_moment import diffusional_growth_factor

    Rv = c.Rv
    L = c.liquid_latent_heat(T)
    pvs = saturation_vapor_pressure(T, c, 1.0)
    g_acc = c.gravitational_acceleration
    rho_l = aa.water_density
    Rm = c.mixture_gas_constant(q)
    cpm = c.mixture_heat_capacity(q)
    pv = q.vapor * rho * Rv * T

    G = diffusional_growth_factor(air, T, c) / rho_l
    alpha = pv / pvs * (L * g_acc / (Rv * cpm * T ** 2) - g_acc / (Rm * T))
    gamma = Rv * T / pvs + pv / pvs * Rm * L ** 2 / (Rv * cpm * T * p)
    A = 2.0 * aa.surface_tension / (rho_l * Rv * T)

    w_pos = jnp.maximum(w, 1e-9)
    awG = jnp.maximum(alpha * w_pos / G, 0.0)
    sqrt_awG = jnp.sqrt(awG)
    zeta = (2.0 / 3.0) * A * sqrt_awG

    inv_smax2 = jnp.zeros_like(T)
    for mode in aa.modes:
        scrit = jnp.maximum(_mode_scrit(aa, mode, A), 1e-12)
        fv = aa.f1 * math.exp(aa.f2 * math.log(mode.stdev) ** 2)
        gv = aa.g1 + aa.g2 * math.log(mode.stdev)
        eta = jnp.maximum(
            sqrt_awG ** 3 / (2.0 * jnp.pi * rho_l * gamma * mode.N), 1e-30)
        inv_smax2 = inv_smax2 + (1.0 / scrit ** 2) * (
            fv * (zeta / eta) ** aa.p1
            + gv * (scrit ** 2 / (eta + 3.0 * zeta)) ** aa.p2)
    smax0 = 1.0 / jnp.sqrt(jnp.maximum(inv_smax2, 1e-30))
    smax0 = jnp.where(w > 0.0, smax0, 0.0)

    # Korolev & Mazin (2003) eq. A13: relaxation by existing droplets.
    Nl = jnp.maximum(ncl_vol, 0.0)
    rl = jnp.where(
        Nl > 1e-6,
        jnp.cbrt(rho * q.liquid / jnp.maximum(
            Nl * rho_l * jnp.pi * 4.0 / 3.0, 1e-30)), 0.0)
    Kl = 4.0 * jnp.pi * rho_l * Nl * rl * G * gamma
    den = alpha * w + Kl * smax0
    safe_den = jnp.where(w > 0.0, den, 1.0)
    smax = jnp.where(w > 0.0, smax0 * alpha * w / safe_den, 0.0)
    return jnp.maximum(smax, 0.0), A


def arg_activated_fraction(aa: AerosolActivation, smax, A):
    """Total activated fraction across modes (ARG2000 eq. 7, lognormal
    erf form)."""
    from jax.scipy.special import erf

    n_tot = sum(m.N for m in aa.modes)
    n_act = jnp.zeros_like(smax)
    smax_safe = jnp.maximum(smax, 1e-12)
    for mode in aa.modes:
        scrit = jnp.maximum(_mode_scrit(aa, mode, A), 1e-12)
        phi = (2.0 * jnp.log(scrit / smax_safe)
               / (3.0 * math.sqrt(2.0) * math.log(mode.stdev)))
        n_act = n_act + 0.5 * (1.0 - erf(phi)) * mode.N
    return n_act / max(n_tot, 1e-30)


def _gamma_fn(a):
    """Γ(a) for static a > 0."""
    return math.gamma(a)


def _gamma_incl(a, x):
    """Non-regularized upper incomplete gamma Γ(a, x) for static a (may be
    ≤ 0, as in the SB2006 number-ventilation integrals — the reference's
    ``Γ_incl``): one step of the recurrence Γ(a, x) = (Γ(a+1, x) −
    xᵃe⁻ˣ)/a lifts a ∈ [−1, 0) to the gammaincc-supported domain."""
    from jax.scipy import special as jss

    if a > 0:
        return jss.gammaincc(a, x) * math.gamma(a)
    if a == 0:
        return jss.exp1(x)
    return (_gamma_incl(a + 1.0, x) - x ** a * jnp.exp(-x)) / a


@dataclasses.dataclass(frozen=True)
class TwoMomentMicrophysics:
    """SB2006-family warm 2M configuration."""

    # aerosol activation: an :class:`AerosolActivation` enables the ARG2000
    # κ-Köhler scheme (reference parity); None falls back to the Twomey
    # power-law proxy N_act = ccn_concentration * s^k (s in %).
    activation: AerosolActivation | None = None
    ccn_concentration: float = 100.0e6    # [1/m³] (Twomey fallback)
    activation_exponent: float = 0.5
    activation_timescale: float = 10.0
    # condensation relaxation
    tau_cond: float = 10.0
    # SB2006 autoconversion (Seifert & Beheng 2006 Table 1 / Eq. 4-6; the
    # CloudMicrophysics.jl ``SB2006`` parameter set the reference delegates
    # to).  kcc = 4.44e9 is the SB2006 value (SB2001's long-kernel 9.44e9
    # is selectable); the Φau/Φacc universal functions are built in.
    kc_autoconversion: float = 4.44e9     # [m³/kg²/s]
    x_star: float = 2.6e-10               # separating droplet mass [kg]
    nu_cloud: float = 2.0                 # cloud gamma-shape parameter
    # accretion (SB2006 Eq. 7-8)
    kr_accretion: float = 5.25            # [m³/kg/s]
    accretion_tau0: float = 5.0e-5        # Φacc timescale constant
    # rain self-collection + breakup (SB2006 Eq. 9/13)
    k_selfcollection: float = 7.12        # [m³/kg/s]
    k_breakup: float = 1000.0             # [1/m]
    kappa_breakup: float = 2300.0         # [1/m]
    D_eq: float = 0.9e-3                  # breakup equilibrium diameter [m]
    D_br_min: float = 0.35e-3             # no breakup below this size [m]
    # rain evaporation ventilation (SB2006 Sec. 3.3 / the reference's
    # ``rain_evaporation_2m`` translation)
    av_vent: float = 0.78
    bv_vent: float = 0.308
    # fall-speed power law v = α x̄^β √(ρ0/ρ) (ventilation Reynolds number)
    rain_v_coefficient: float = 159.0     # α [m/s kg^-β]
    rain_v_exponent: float = 0.266        # β
    # SB2006VelType sedimentation (Rogers): v = √(ρ0/ρ)(aR − bR(1+cR/λ)^-k)
    rogers_aR: float = 9.65               # [m/s]
    rogers_bR: float = 10.3               # [m/s]
    rogers_cR: float = 600.0              # [1/m]
    rho0_air: float = 1.225               # SB2006 reference density [kg/m³]
    water_density: float = 1000.0         # [kg/m³]
    max_terminal_velocity: float = 10.0
    substep_cfl: float = 0.8
    # droplet bounds
    min_droplet_mass: float = 4.2e-15     # ~1 µm radius
    max_droplet_mass: float = 2.6e-10
    min_rain_mass: float = 2.6e-10
    max_rain_mass: float = 5.0e-6

    # host-side sedimentation trip count is computed from dt
    requires_static_dt = True

    prognostic_tracer_names = ("rho_qcl", "rho_qr", "rho_ncl", "rho_nr")
    liquid_tracer_names = ("rho_qcl", "rho_qr")
    ice_tracer_names = ()
    # reference two_moment_microphysics.jl:348-354
    correction_tracer_chain = ("rho_qr", "rho_qcl")
    correction_number_mass_pairs = (("rho_nr", "rho_qr"), ("rho_ncl", "rho_qcl"))
    correction_number_fields = ("rho_ncl", "rho_nr")

    def model_update(self, model, state, dt: float):
        return two_moment_update(self, model, state, float(dt))


def two_moment_update(scheme: TwoMomentMicrophysics, model, state, dt: float):
    g = model.grid
    c = model.constants
    ref = model.reference
    rho = jnp.broadcast_to(ref.rho_col, g.shape).astype(g.dtype)
    p = jnp.broadcast_to(ref.p_col, g.shape).astype(g.dtype)
    dz = g.dz_c_col
    rho_surf = ref.rho_c[0]

    qv = jnp.maximum(state.rho_qt / rho, 0.0)
    zeros = jnp.zeros_like(qv)
    qcl = jnp.maximum(state.tracers.get("rho_qcl", zeros) / rho, 0.0)
    qr = jnp.maximum(state.tracers.get("rho_qr", zeros) / rho, 0.0)
    ncl = jnp.maximum(state.tracers.get("rho_ncl", zeros) / rho, 0.0)  # [1/kg]
    nr = jnp.maximum(state.tracers.get("rho_nr", zeros) / rho, 0.0)
    theta = state.rho_theta / rho

    n_sub = max(1, math.ceil(dt * scheme.max_terminal_velocity
                             / (scheme.substep_cfl * g.dz_min)))
    dts = dt / n_sub

    # Vertical velocity at centers for ARG activation (fixed over the
    # operator-split microphysics interval; reference uses the state's w).
    if scheme.activation is not None:
        rho_f = jnp.broadcast_to(ref.rho_f_col[: g.nz], g.shape).astype(g.dtype)
        w_face = state.rho_w / rho_f
        w_c = 0.5 * (w_face + jnp.concatenate(
            [w_face[1:], jnp.zeros_like(w_face[:1])], axis=0))
    else:
        w_c = None

    def subcycle(m, carry):
        qv, qcl, qr, ncl, nr = carry
        qv1, qcl1, qr1, ncl1, nr1 = two_moment_process_step(
            scheme, qv, qcl, qr, ncl, nr, theta, rho, p, w_c, dts, c,
            model.p_standard)

        # --- sedimentation of rain (SB2006VelType, Rogers-type mean
        # fall speeds: mass- and number-weighted differ through the
        # exponential DSD) --------------------------------------------
        rho_corr = jnp.sqrt(scheme.rho0_air / rho)
        # fall speeds from the PRE-update mean rain mass (exact numerics of
        # the pre-refactor in-subcycle ordering)
        x_r = jnp.clip(jnp.where(nr > 1e-6, qr / jnp.maximum(nr, 1e-6),
                                 0.0),
                       scheme.min_rain_mass, scheme.max_rain_mass)
        lam_r = jnp.cbrt(jnp.pi * scheme.water_density / x_r)
        vmax = scheme.max_terminal_velocity

        def rogers_v(k):
            return jnp.clip(
                rho_corr * (scheme.rogers_aR - scheme.rogers_bR
                            * (1.0 + scheme.rogers_cR / lam_r) ** (-k)),
                0.0, vmax)

        v_q = rogers_v(4.0)      # mass-weighted
        v_N = rogers_v(1.0)      # number-weighted

        def settle(q, v):
            flux = rho * q * v
            flux_above = jnp.concatenate([flux[1:], jnp.zeros_like(flux[:1])], 0)
            return jnp.maximum(q + dts * (flux_above - flux) / (rho * dz), 0.0)

        qr1 = settle(qr1, v_q)
        nr1 = settle(nr1, v_N)

        return qv1, qcl1, qr1, ncl1, nr1

    qv, qcl, qr, ncl, nr = jax.lax.fori_loop(
        0, n_sub, subcycle, (qv, qcl, qr, ncl, nr))

    tracers = dict(state.tracers)
    tracers["rho_qcl"] = rho * qcl
    tracers["rho_qr"] = rho * qr
    tracers["rho_ncl"] = rho * ncl
    tracers["rho_nr"] = rho * nr
    return state.replace(rho_qt=rho * qv, tracers=tracers)


def two_moment_process_step(scheme, qv, qcl, qr, ncl, nr, theta, rho, p,
                            w_c, dts, c, p_standard):
    """ONE forward-Euler step of every POINTWISE SB2006 process
    (activation, condensation/evaporation, auto-conversion, accretion,
    self-collection/breakup, ventilated rain evaporation) — everything in
    the grid subcycle except sedimentation.  Shared verbatim by
    :func:`two_moment_update` and the 0-D parcel coupling
    (:mod:`breeze_tpu.parcel`), so parcel rates ARE the grid rates at
    matched (θ, ρ, p, w) — the reference parcel materializes the same
    scheme prognostics (``parcel_dynamics.jl:245-283``) and feeds parcel
    w into activation (``:578-584``)."""
    q_mmf = MoistureMassFractions(qv, qcl + qr, jnp.zeros_like(qv))
    T = temperature_from_theta_li(theta, q_mmf, p, c, p_standard)
    qvs = saturation_specific_humidity(T, rho, c, 1.0)
    s_pct = jnp.maximum(0.0, (qv / qvs - 1.0)) * 100.0

    dq_act = 0.0
    if scheme.activation is not None:
        # --- ARG2000 κ-Köhler activation (reference
        # two_moment_microphysics.jl:749-860) ----------------------
        from .one_moment import AirProperties
        aa = scheme.activation
        smax, A = arg_max_supersaturation(
            aa, AirProperties(), rho, w_c, T, p, q_mmf, ncl * rho, c)
        frac = arg_activated_fraction(aa, smax, A)
        n_avail = sum(mode.N for mode in aa.modes) / rho   # per-mass
        n_star = frac * n_avail
        s_inst = qv / qvs - 1.0
        act = jnp.where(
            s_inst > 0.0,
            jnp.clip(n_star - ncl, 0.0, n_avail)
            / max(aa.nucleation_timescale, dts),
            0.0)
        # Köhler activation radius r = 2A/(3S) → initial droplet mass
        r_act = jnp.clip(2.0 * A / (3.0 * jnp.maximum(s_inst, 1e-12)),
                         aa.nucleation_radius, aa.max_activation_radius)
        dq_act = act * (4.0 / 3.0) * jnp.pi * r_act ** 3 * aa.water_density
        dq_act = jnp.minimum(dq_act, jnp.maximum(qv, 0.0) / dts)
    else:
        # --- activation (Twomey proxy) ----------------------------
        n_act = scheme.ccn_concentration / rho * jnp.minimum(
            s_pct ** scheme.activation_exponent, 1.0)   # per-mass [1/kg]
        act = jnp.maximum(0.0, n_act - ncl) / scheme.activation_timescale

    # --- condensation / evaporation of cloud --------------------
    cond = (qv - qvs) / scheme.tau_cond
    cond = jnp.where(cond > 0, cond, jnp.maximum(cond, -qcl / dts))
    # evaporation removes droplets proportionally
    evap_frac = jnp.where(qcl > 1e-12, jnp.maximum(-cond, 0.0) * dts / jnp.maximum(qcl, 1e-12), 0.0)
    dncl_evap = -ncl * jnp.minimum(evap_frac, 1.0) / dts

    # shared quantities
    rho_corr = jnp.sqrt(scheme.rho0_air / rho)   # √(ρ0/ρ) (SB2006)
    x_cl = jnp.clip(jnp.where(ncl > 1e-3, qcl / jnp.maximum(ncl, 1e-3), 0.0),
                    scheme.min_droplet_mass, scheme.max_droplet_mass)
    x_r = jnp.clip(jnp.where(nr > 1e-6, qr / jnp.maximum(nr, 1e-6), 0.0),
                   scheme.min_rain_mass, scheme.max_rain_mass)
    # τ = 1 − qc/(qc+qr); clip away from 1 in f32-safe distance (the
    # φau/(1−τ)² enhancement only matters when qc > 0, where τ < 1)
    tau = jnp.clip(1.0 - qcl / jnp.maximum(qcl + qr, 1e-20), 1e-12,
                   1.0 - 1e-5)

    # --- SB2006 autoconversion (Eq. 4-6) -------------------------
    nu = scheme.nu_cloud
    phi_au = 400.0 * tau ** 0.7 * (1.0 - tau ** 0.7) ** 3
    au = (scheme.kc_autoconversion / (20.0 * scheme.x_star)
          * (nu + 2.0) * (nu + 4.0) / (nu + 1.0) ** 2
          * qcl ** 2 * x_cl ** 2 * rho
          * (1.0 + phi_au / (1.0 - tau) ** 2))
    au = jnp.minimum(au, qcl / dts)
    dnr_au = au / scheme.x_star
    dncl_au = -2.0 * au / scheme.x_star          # SB2006: −2/x* ∂L/∂t

    # --- cloud self-collection (Eq. 5: only Nc, no mass) ---------
    dncl_sc = -(scheme.kc_autoconversion * (nu + 2.0) / (nu + 1.0)
                * qcl ** 2 * rho)

    # --- accretion (Eq. 7-8) -------------------------------------
    phi_ac = (tau / (tau + scheme.accretion_tau0)) ** 4
    ac = scheme.kr_accretion * qcl * qr * rho * phi_ac * rho_corr
    ac = jnp.minimum(ac, jnp.maximum(qcl / dts - au, 0.0))
    dncl_ac = -ac / jnp.maximum(x_cl, scheme.min_droplet_mass)

    # --- rain self-collection + breakup (Eq. 9/13) ---------------
    rho_w = scheme.water_density
    D_r = jnp.cbrt(6.0 * x_r / (jnp.pi * rho_w))
    sc = scheme.k_selfcollection * nr * qr * rho * rho_corr
    dD = D_r - scheme.D_eq
    phi_br = jnp.where(
        D_r < scheme.D_br_min, -1.0,
        jnp.where(D_r <= scheme.D_eq, scheme.k_breakup * dD,
                  2.0 * jnp.exp(scheme.kappa_breakup * dD) - 1.0))
    dnr_scbr = phi_br * sc                        # −sc ... +breakup

    # --- rain evaporation (SB2006 ventilated; the reference's
    # rain_evaporation_2m translation) -----------------------------
    from .one_moment import AirProperties, diffusional_growth_factor
    air = AirProperties()
    beta = scheme.rain_v_exponent
    Gf = diffusional_growth_factor(air, T, c)
    S = qv / qvs - 1.0                            # liquid supersaturation
    t_star = jnp.cbrt(6.0 * scheme.x_star / x_r)
    a_v0 = scheme.av_vent * _gamma_incl(-1.0, t_star) / 6.0 ** (-2.0 / 3.0)
    b_v0 = (scheme.bv_vent * _gamma_incl(-0.5 + 1.5 * beta, t_star)
            / 6.0 ** ((beta - 1.0) / 2.0))
    a_v1 = scheme.av_vent * 1.0 / jnp.cbrt(6.0)           # Γ(2) = 1
    b_v1 = (scheme.bv_vent * _gamma_fn(2.5 + 1.5 * beta)
            / 6.0 ** ((beta + 1.0) / 2.0))
    Re = (scheme.rain_v_coefficient * x_r ** beta * rho_corr * D_r
          / air.nu_air)
    schmidt = jnp.cbrt(air.nu_air / air.D_vapor) * jnp.sqrt(Re)
    Fv0 = a_v0 + b_v0 * schmidt
    Fv1 = a_v1 + b_v1 * schmidt
    Nr_vol = nr * rho                             # [1/m³]
    evaporating = (S < 0.0) & (qr > 1e-15) & (nr > 1e-6)
    dnr_evap = jnp.where(
        evaporating,
        jnp.minimum(0.0, 2.0 * jnp.pi * Gf * S * Nr_vol * D_r * Fv0
                    / x_r) / rho,                 # per-mass [1/kg/s]
        0.0)
    evap_r = jnp.where(
        evaporating,
        -jnp.minimum(0.0, 2.0 * jnp.pi * Gf * S * Nr_vol * D_r * Fv1
                     / rho),                      # [kg/kg/s] ≥ 0
        0.0)
    evap_r = jnp.minimum(evap_r, qr / dts)

    # --- update -------------------------------------------------
    qv1 = jnp.maximum(qv - dts * (cond + dq_act) + dts * evap_r, 0.0)
    qcl1 = jnp.maximum(qcl + dts * (cond + dq_act - au - ac), 0.0)
    qr1 = jnp.maximum(qr + dts * (au + ac - evap_r), 0.0)
    ncl1 = jnp.maximum(ncl + dts * (act + dncl_evap + dncl_au
                                    + dncl_sc + dncl_ac), 0.0)
    nr1 = jnp.maximum(nr + dts * (dnr_au + dnr_scbr + dnr_evap), 0.0)

    # clamp orphaned numbers (no mass → no number; reference
    # negative_moisture_correction clamps orphaned concentrations)
    ncl1 = jnp.where(qcl1 > 1e-12, ncl1, 0.0)
    nr1 = jnp.where(qr1 > 1e-12, nr1, 0.0)

    return qv1, qcl1, qr1, ncl1, nr1
