"""DCMIP2016 Kessler pinning: the vectorized JAX scheme against an
independent sequential NumPy column implementation of the published
Klemp & Wilhelmson (1978) / DCMIP2016 algorithm (kessler.f90,
DOI 10.5281/zenodo.1298671), adapted to θˡⁱ thermodynamics the same way the
reference pins its implementation (``test/dcmip2016_kessler.jl`` translates
the Fortran and asserts rtol 1e-12 agreement).

The NumPy version below is written with plain per-level loops and the
published process formulas; agreement validates the fused/vectorized JAX
implementation (ratio conversions, upwind sedimentation shift, fori_loop
subcycling, implicit accretion) at machine precision.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np

import breeze_tpu as bz
from breeze_tpu.model import initial_state, make_model
from breeze_tpu.physics.kessler import KesslerMicrophysics, kessler_update
from breeze_tpu.thermo.constants import (CondensedPhase, IdealGas,
                                         MoistureMassFractions,
                                         ThermodynamicConstants)

# DCMIP2016-style constants (the reference test's configuration): equal dry
# and vapor gas constants / heat capacities, Tetens saturation, L = 2.5e6.
R_GAS = 8.314462618
RD = 287.0
CP = 1003.0
LL = 2.5e6

CONST = ThermodynamicConstants(
    dry_air=IdealGas(molar_mass=R_GAS / RD, heat_capacity=CP),
    vapor=IdealGas(molar_mass=R_GAS / RD, heat_capacity=CP),
    liquid=CondensedPhase(reference_latent_heat=LL, heat_capacity=CP),
    saturation_formulation="tetens",
)

P0 = 1.0e5


def mixture_cp_R(qv, ql):
    """With equal gas constants/heat capacities these are constant, but keep
    the general mixture forms the scheme uses."""
    qd = 1.0 - qv - ql
    cpm = qd * CP + qv * CP + ql * CP
    Rm = qd * RD + qv * RD
    return cpm, Rm


def T_from_theta_li(theta_li, qv, ql, p):
    cpm, Rm = mixture_cp_R(qv, ql)
    Pi = (p / P0) ** (Rm / cpm)
    return Pi * theta_li + LL * ql / cpm


def theta_li_from_T(T, qv, ql, p):
    cpm, Rm = mixture_cp_R(qv, ql)
    Pi = (p / P0) ** (Rm / cpm)
    return (T - LL * ql / cpm) / Pi


def tetens_qvs(T, rho):
    """Density-based saturation specific humidity with the Tetens fit —
    exactly the scheme's stated closure (q* = p*(T)/(ρ Rᵛ T); here Rᵛ=Rᵈ)."""
    es = 610.0 * math.exp(17.27 * (T - 273.15) / (T - 35.85))
    return es / (rho * RD * T)


def numpy_kessler_column(scheme, theta, rv, rcl, rr, rho, p, dz, dt, rho_surf):
    """Sequential single-column DCMIP2016 Kessler step (published algorithm
    order: terminal velocity → sedimentation → autoconversion/accretion →
    saturation adjustment + rain evaporation → latent heating)."""
    nz = len(rv)
    theta, rv, rcl, rr = (np.array(theta, np.float64), np.array(rv),
                          np.array(rcl), np.array(rr))
    n_sub = max(1, math.ceil(dt * scheme.max_terminal_velocity
                             / (scheme.substep_cfl * dz)))
    dts = dt / n_sub
    f5 = scheme.tetens_a * scheme.dcmip_temperature_scale * LL / CP
    precip = 0.0

    for _ in range(n_sub):
        W = np.zeros(nz)
        for k in range(nz):
            W[k] = (scheme.terminal_velocity_coefficient
                    * max(rr[k] * scheme.density_scale * rho[k], 0.0)
                    ** scheme.terminal_velocity_exponent
                    * math.sqrt(rho_surf / rho[k]))

        qr1 = rr[0] / (1.0 + rv[0] + rcl[0] + rr[0])
        precip += qr1 * W[0]

        # upwind sedimentation, zero inflow at the top
        rho_k = scheme.density_scale * np.asarray(rho)
        flux = rho_k * rr * W
        dr_sed = np.zeros(nz)
        for k in range(nz):
            f_above = flux[k + 1] if k + 1 < nz else 0.0
            dr_sed[k] = dts * (f_above - flux[k]) / (rho_k[k] * dz)

        for k in range(nz):
            qv_k = rv[k] / (1.0 + rv[k] + rcl[k] + rr[k])
            ql_k = (rcl[k] + rr[k]) / (1.0 + rv[k] + rcl[k] + rr[k])
            T = T_from_theta_li(theta[k], qv_k, ql_k, p[k])

            # implicit autoconversion + accretion (KW78 eq. 2.13)
            A = max(0.0, scheme.autoconversion_rate
                    * (rcl[k] - scheme.autoconversion_threshold))
            denom = (1.0 + dts * scheme.accretion_rate
                     * max(rr[k], 0.0) ** scheme.accretion_exponent)
            drP = rcl[k] - (rcl[k] - dts * A) / denom
            rcl_1 = max(0.0, rcl[k] - drP)
            rr_1 = max(0.0, rr[k] + drP + dr_sed[k])

            qvs = tetens_qvs(T, rho[k])
            rvs = qvs / (1.0 - qvs)
            dr_sat = (rv[k] - rvs) / (1.0 + rvs * f5
                                      / (T - scheme.tetens_dT) ** 2)

            # rain evaporation (KW78 eq. 2.14)
            rho_rr = rho_k[k] * rr_1
            Vev = ((scheme.evaporation_ventilation_coefficient_1
                    + scheme.evaporation_ventilation_coefficient_2
                    * rho_rr ** scheme.evaporation_ventilation_exponent_1)
                   * rho_rr ** scheme.evaporation_ventilation_exponent_2)
            Dth = (scheme.diffusivity_coefficient / (p[k] * rvs)
                   + scheme.thermal_conductivity_coefficient)
            dr_vs = max(0.0, rvs - rv[k])
            E_r = Vev / Dth * dr_vs / (rho_k[k] * rvs + 1e-20)
            dr_E_max = max(0.0, -dr_sat - rcl_1)
            dr_E = min(min(dts * E_r, dr_E_max), rr_1)

            dr_C = max(dr_sat, -rcl_1)
            rv_new = max(0.0, rv[k] - dr_C + dr_E)
            rcl_new = rcl_1 + dr_C
            rr_new = rr_1 - dr_E

            T_new = T + LL / CP * (dr_C - dr_E)
            rt = rv_new + rcl_new + rr_new
            qv_n = rv_new / (1.0 + rt)
            ql_n = (rcl_new + rr_new) / (1.0 + rt)
            theta[k] = theta_li_from_T(T_new, qv_n, ql_n, p[k])
            rv[k], rcl[k], rr[k] = rv_new, rcl_new, rr_new

    return theta, rv, rcl, rr, precip / n_sub


def test_kessler_matches_independent_column():
    nz, dz = 30, 250.0
    z = (np.arange(nz) + 0.5) * dz

    # linear-lapse atmosphere (the reference test's profile)
    T_prof = 288.0 - 0.0065 * z
    p_prof = 101325.0 * (T_prof / 288.0) ** (9.81 / (RD * 0.0065))
    rho_prof = p_prof / (RD * T_prof)

    rv0 = 0.015 * np.exp(-(((z - 1000.0) / 1000.0) ** 2))
    rcl0 = np.where((z > 1500.0) & (z < 2500.0), 0.002, 0.0)
    rr0 = np.where((z > 1000.0) & (z < 2000.0), 0.0005, 0.0)

    g = bz.make_grid(size=(4, 1, nz), extent=(4000.0, 1.0, nz * dz),
                     topology=(bz.PERIODIC, bz.FLAT, bz.BOUNDED),
                     dtype=jnp.float64)
    scheme = KesslerMicrophysics()
    model = make_model(g, advection=bz.Centered(2), constants=CONST,
                       potential_temperature=300.0, microphysics=scheme)
    # pin the reference columns to the analytic profile (the scheme reads
    # ρ, p from the anelastic reference)
    model = dataclasses.replace(
        model, reference=dataclasses.replace(
            model.reference,
            p_c=jnp.asarray(p_prof), rho_c=jnp.asarray(rho_prof),
            T_c=jnp.asarray(T_prof)))

    # initial θˡⁱ consistent with (T, q, p)
    rt0 = rv0 + rcl0 + rr0
    qv0 = rv0 / (1.0 + rt0)
    qcl0 = rcl0 / (1.0 + rt0)
    qr0 = rr0 / (1.0 + rt0)
    theta0 = theta_li_from_T(T_prof, qv0, qcl0 + qr0, p_prof)

    col = lambda a: jnp.broadcast_to(jnp.asarray(a)[:, None, None], g.shape)
    state = initial_state(model, theta=col(theta0), qt=col(qv0))
    tr = dict(state.tracers)
    rho_col = model.reference.rho_col
    tr["rho_qcl"] = rho_col * col(qcl0)
    tr["rho_qr"] = rho_col * col(qr0)
    state = state.replace(tracers=tr)

    dt = 10.0
    new_state, precip = kessler_update(scheme, model, state, dt)

    # independent column
    rv_ratio0 = qv0 / (1.0 - (qv0 + qcl0 + qr0))
    rcl_ratio0 = qcl0 / (1.0 - (qv0 + qcl0 + qr0))
    rr_ratio0 = qr0 / (1.0 - (qv0 + qcl0 + qr0))
    theta_np, rv_np, rcl_np, rr_np, precip_np = numpy_kessler_column(
        scheme, theta0, rv_ratio0, rcl_ratio0, rr_ratio0,
        rho_prof, p_prof, dz, dt, float(rho_prof[0]))

    rt = rv_np + rcl_np + rr_np
    qv_np = rv_np / (1.0 + rt)
    qcl_np = rcl_np / (1.0 + rt)
    qr_np = rr_np / (1.0 + rt)

    qv_jax = np.asarray(new_state.rho_qt / rho_col)[:, 0, 0]
    qcl_jax = np.asarray(new_state.tracers["rho_qcl"] / rho_col)[:, 0, 0]
    qr_jax = np.asarray(new_state.tracers["rho_qr"] / rho_col)[:, 0, 0]
    th_jax = np.asarray(new_state.rho_theta / rho_col)[:, 0, 0]

    np.testing.assert_allclose(qv_jax, qv_np, rtol=1e-11, atol=1e-14)
    np.testing.assert_allclose(qcl_jax, qcl_np, rtol=1e-11, atol=1e-14)
    np.testing.assert_allclose(qr_jax, qr_np, rtol=1e-11, atol=1e-14)
    np.testing.assert_allclose(th_jax, theta_np, rtol=1e-11)
    np.testing.assert_allclose(float(precip[0, 0]), precip_np, rtol=1e-11)

    # something actually happened (autoconversion + sedimentation active)
    assert float(np.abs(qr_jax - qr0).max()) > 1e-7
    assert precip_np >= 0.0


def test_kessler_terminal_velocity_pinned():
    """Published KW78 terminal-velocity values: W = 36.34(ρ r 1e-3)^0.1364
    √(ρ₁/ρ) — pinned at the reference test's probe point."""
    s = KesslerMicrophysics()
    W = float(s.terminal_velocity(jnp.float64(0.001), 1.0, 1.2))
    expect = 36.34 * (0.001 * 0.001 * 1.0) ** 0.1364 * math.sqrt(1.2)
    np.testing.assert_allclose(W, expect, rtol=1e-12)
    assert 0.0 < W < 20.0
    assert float(s.terminal_velocity(jnp.float64(0.0), 1.0, 1.2)) == 0.0
    assert float(s.terminal_velocity(jnp.float64(0.005), 1.0, 1.2)) > W
