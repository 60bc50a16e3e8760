"""Microphysics schemes: saturation adjustment (0-moment equilibrium).

Equivalent of reference ``src/Microphysics/saturation_adjustment.jl``
(`SaturationAdjustment` :23, `adjust_thermodynamic_state` :193-264, residual
:173-180).  The per-cell secant iteration is vectorized over whole fields
with a fixed trip count (the reference's ``FixedIterations`` mode, which it
requires for XLA tracing too); both saturated/unsaturated branches are
evaluated and blended with ``jnp.where`` — branch-free vector code.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from ..thermo.constants import MoistureMassFractions, ThermodynamicConstants
from ..thermo.saturation import (
    MixedPhaseEquilibrium,
    WarmPhaseEquilibrium,
    saturation_specific_humidity,
    saturation_vapor_pressure,
    saturation_vapor_pressure_slope_ratio,
)
from ..thermo.states import temperature_from_theta_li


@dataclasses.dataclass(frozen=True)
class SaturationAdjustment:
    """Instantaneous equilibrium condensation microphysics.

    ``equilibrium`` is :class:`WarmPhaseEquilibrium` or
    :class:`MixedPhaseEquilibrium`; ``iterations`` is the fixed solver trip
    count (reference default solver: SecantSolver(abstol=1e-4, maxiter=20);
    a fixed count with no convergence branch is the form the reference
    itself uses under Reactant/XLA).

    ``solver``: ``"newton"`` (default) iterates with the analytic
    Clausius-Clapeyron residual slope — quadratic convergence, 3 trips
    reach the reference abstol=1e-4 from any tropospheric state and cost
    ~half the secant's 6 residual evaluations (the adjustment's cost is its
    transcendental evaluations, so trip count is wall time).
    ``"secant"`` restores the derivative-free loop (use iterations>=5).
    """

    equilibrium: object = dataclasses.field(default_factory=WarmPhaseEquilibrium)
    iterations: int = 3
    solver: str = "newton"
    # Newton trip count when a warm-start temperature is available (RK3
    # stages 2-3 pass the previous stage's converged T, which is within
    # |Δθ| ~ O(αΔt·tendency) ≪ 1 K of the root — quadratic convergence
    # puts 2 trips far below the reference abstol 1e-4).  Each trip costs
    # its transcendental evaluations, so trips are wall time.
    # Accuracy contract: max|T_warm − T_converged| < 1e-4 K along a stepped
    # condensing trajectory (tests/test_microphysics_schemes.py::
    # TestWarmStartAccuracy) — a Δt or stability change that degrades the
    # warm chain fails that test, not silently this knob.
    warm_iterations: int = 2


def adjustment_saturation_specific_humidity(T, p, qt, constants, lam):
    """Always-saturated branch (Pressel 2015 eq. 37): condensate present.

    qᵛ⁺ = ε (1 − qᵗ) pᵛ⁺ / (p − pᵛ⁺)
    """
    pvs = saturation_vapor_pressure(T, constants, lam)
    eps = constants.epsilon_dv
    return eps * (1.0 - qt) * pvs / (p - pvs)


def equilibrated_moisture_fractions(T, qt, qvs, equilibrium) -> MoistureMassFractions:
    """Partition qᵗ into vapor + condensate; split condensate by λ(T)."""
    qc = jnp.maximum(0.0, qt - qvs)
    qv = qt - qc
    lam = equilibrium.liquid_fraction(T)
    if isinstance(equilibrium, WarmPhaseEquilibrium):
        return MoistureMassFractions(qv, qc, jnp.zeros_like(qc))
    return MoistureMassFractions(qv, lam * qc, (1.0 - lam) * qc)


def _newton_adjust_T(T0, qt, p, constants: ThermodynamicConstants, eq,
                     iterations: int, T_back_of):
    """Fixed-count Newton on r(T) = T − T_back(q_eq(T)) for the
    always-saturated branch shared by the θˡⁱ and static-energy adjustments.

    Analytic quasi-Newton slope (the weak Π(q)/cᵖᵐ(q) composition
    dependence is dropped — it perturbs the convergence path, not the root):

        dr/dT = 1 + [L_eff·dqᵛ⁺/dT − qᶜ(Lˡᵣ−Lⁱᵣ)dλ/dT] / cᵖᵐ

    with dqᵛ⁺/dT = qᵛ⁺ · (dpᵛ⁺/dT)/pᵛ⁺ · p/(p−pᵛ⁺) from the saturated
    branch qᵛ⁺ = ε(1−qᵗ)pᵛ⁺/(p−pᵛ⁺).  Quadratic convergence: 3 trips meet
    the reference SecantSolver abstol=1e-4 (saturation_adjustment.jl:50)
    from the latent-overshoot first guess at half the secant's residual
    evaluations.
    """
    Ll = constants.liquid.reference_latent_heat
    Li = constants.ice.reference_latent_heat
    eps = constants.epsilon_dv
    T = T0
    for _ in range(iterations):
        lam = eq.liquid_fraction(T)
        pvs = saturation_vapor_pressure(T, constants, lam)
        inv_pmp = 1.0 / (p - pvs)          # shared by qvs and dqvs (one divide)
        qvs = eps * (1.0 - qt) * pvs * inv_pmp
        q = equilibrated_moisture_fractions(T, qt, qvs, eq)
        r = T - T_back_of(T, q)
        cpm = constants.mixture_heat_capacity(q)
        L_eff = lam * Ll + (1.0 - lam) * Li
        dqvs = (qvs * saturation_vapor_pressure_slope_ratio(T, constants, lam)
                * p * inv_pmp)
        drdT = 1.0 + L_eff * dqvs / cpm
        if isinstance(eq, MixedPhaseEquilibrium):
            qc = jnp.maximum(0.0, qt - qvs)
            Tf = eq.freezing_temperature
            Th = eq.homogeneous_ice_nucleation_temperature
            dlam = jnp.where((T > Th) & (T < Tf), 1.0 / (Tf - Th), 0.0)
            drdT = drdT - qc * (Ll - Li) * dlam / cpm
        # slope floor + step clip: safety at the λ(T) ramp kinks
        T = T - jnp.clip(r / jnp.maximum(drdT, 0.1), -25.0, 25.0)
    return T


def _newton_adjust_T_theta_li(T0, qt, p, theta_li,
                              constants: ThermodynamicConstants, eq,
                              iterations: int, p_standard: float):
    """θˡⁱ-specialized variant of :func:`_newton_adjust_T` with a
    linearized Exner update: Π depends on the state only through
    k = Rᵐ/cᵖᵐ, and over a Newton solve k moves by |Δk| ≲ 2e-5, so
    Π(k) = Π(k₀)·exp((k−k₀)·log(p/pˢᵗ)) ≈ Π₀·(1 + (k−k₀)·logπ) with
    relative error (Δk·logπ)²/2 ≲ 1e-9 — ONE full-field exp for the whole
    solve instead of one per trip (the adjustment's cost is its
    transcendental evaluations).  ``1/cᵖᵐ`` is likewise computed once
    per trip and shared by the latent and slope terms.

    Returns ``(T, qvs)`` — the converged temperature and the saturation
    specific humidity AT that temperature (from the last trip's
    linearized pvs), so callers need no extra svp evaluation.
    """
    Ll = constants.liquid.reference_latent_heat
    Li = constants.ice.reference_latent_heat
    eps = constants.epsilon_dv
    logp = jnp.log(p / p_standard)
    T = T0
    Pi0 = k0 = None
    pvs = slope = dT_step = None
    for i in range(iterations):
        lam = eq.liquid_fraction(T)
        pvs = saturation_vapor_pressure(T, constants, lam)
        inv_pmp = 1.0 / (p - pvs)
        qvs = eps * (1.0 - qt) * pvs * inv_pmp
        q = equilibrated_moisture_fractions(T, qt, qvs, eq)
        Rm = constants.mixture_gas_constant(q)
        cpm = constants.mixture_heat_capacity(q)
        inv_cpm = 1.0 / cpm
        k = Rm * inv_cpm
        if i == 0:
            Pi = jnp.exp(k * logp)
            Pi0, k0 = Pi, k
        else:
            Pi = Pi0 * (1.0 + (k - k0) * logp)
        r = T - (Pi * theta_li + (Ll * q.liquid + Li * q.ice) * inv_cpm)
        L_eff = lam * Ll + (1.0 - lam) * Li
        slope = saturation_vapor_pressure_slope_ratio(T, constants, lam)
        dqvs = qvs * slope * p * inv_pmp
        drdT = 1.0 + L_eff * dqvs * inv_cpm
        if isinstance(eq, MixedPhaseEquilibrium):
            qc = jnp.maximum(0.0, qt - qvs)
            Tf = eq.freezing_temperature
            Th = eq.homogeneous_ice_nucleation_temperature
            dlam = jnp.where((T > Th) & (T < Tf), 1.0 / (Tf - Th), 0.0)
            drdT = drdT - qc * (Ll - Li) * dlam * inv_cpm
        dT_step = -jnp.clip(r / jnp.maximum(drdT, 0.1), -25.0, 25.0)
        T = T + dT_step
    # qᵛ⁺ at the converged T from the last trip's linearized pvs
    # (pvs·exp(slope·ΔT) ≈ pvs·(1+slope·ΔT); the final ΔT is ≲ 1e-2 K, so
    # the quadratic remainder is ≲ 2e-7 relative) — saves the extra exact
    # svp evaluation per solve on the transcendental-bound path.
    pvs_f = pvs * (1.0 + slope * dT_step)
    qvs_f = eps * (1.0 - qt) * pvs_f / (p - pvs_f)
    return T, qvs_f


def saturation_adjust_static_energy(e, z, qt, p, constants: ThermodynamicConstants,
                                    scheme: "SaturationAdjustment",
                                    T_guess=None):
    """Saturation-adjusted (T, q) from prognostic moist static energy.

    Static-energy analogue of :func:`saturation_adjust` (reference
    ``StaticEnergyState`` pathway, ``dynamic_states.jl:270``): solve
    T = (e − gz + ℒˡᵣqˡ(T) + ℒⁱᵣqⁱ(T)) / cᵖᵐ(q(T)) with equilibrium
    partitioning at pressure p.
    """
    from ..thermo.states import temperature_from_static_energy

    eq = scheme.equilibrium
    g_acc = constants.gravitational_acceleration

    q1 = MoistureMassFractions.vapor_only(qt)
    T1 = temperature_from_static_energy(e, z, q1, constants)
    lam1 = eq.liquid_fraction(T1)
    rho1 = constants.density(T1, p, q1)
    qvs1 = saturation_specific_humidity(T1, rho1, constants, lam1)
    saturated = qt > qvs1

    def residual(T):
        lam = eq.liquid_fraction(T)
        qvs = adjustment_saturation_specific_humidity(T, p, qt, constants, lam)
        q = equilibrated_moisture_fractions(T, qt, qvs, eq)
        return T - temperature_from_static_energy(e, z, q, constants)

    lam = eq.liquid_fraction(T1)
    qvs_a = adjustment_saturation_specific_humidity(T1, p, qt, constants, lam)
    qa = equilibrated_moisture_fractions(T1, qt, qvs_a, eq)
    cpm = constants.mixture_heat_capacity(qa)
    Ll = constants.liquid.reference_latent_heat
    Li = constants.ice.reference_latent_heat
    dT = (Ll * qa.liquid + Li * qa.ice) / cpm
    # damped Newton first step (see saturation_adjust)
    L_eff1 = lam * Ll + (1.0 - lam) * Li
    pvs_a = saturation_vapor_pressure(T1, constants, lam)
    dqvs1 = (qvs_a * saturation_vapor_pressure_slope_ratio(T1, constants, lam)
             * p / (p - pvs_a))
    T2 = T1 + jnp.maximum(0.01, dT / (1.0 + L_eff1 * dqvs1 / cpm))

    if scheme.solver == "newton":
        from ..thermo.states import temperature_from_static_energy as _T_of_e
        if T_guess is not None:
            # warm start (see saturation_adjust): previous stage's T
            T2, iters = jnp.maximum(T_guess, T1 + 0.01), scheme.warm_iterations
        else:
            iters = scheme.iterations
        Tb = _newton_adjust_T(T2, qt, p, constants, eq, iters,
                              lambda T, q: _T_of_e(e, z, q, constants))
    else:
        Ta, Tb = T1, T2
        ra = residual(Ta)
        for _ in range(scheme.iterations):
            rb = residual(Tb)
            dr = rb - ra
            safe = jnp.where(jnp.abs(dr) > 0, dr, jnp.ones_like(dr))
            Tc = jnp.where(jnp.abs(dr) > 0, Tb - rb * (Tb - Ta) / safe, Tb)
            Ta, ra, Tb = Tb, rb, Tc

    lam_s = eq.liquid_fraction(Tb)
    qvs_s = adjustment_saturation_specific_humidity(Tb, p, qt, constants, lam_s)
    q_sat = equilibrated_moisture_fractions(Tb, qt, qvs_s, eq)

    T = jnp.where(saturated, Tb, T1)
    q = MoistureMassFractions(
        jnp.where(saturated, q_sat.vapor, q1.vapor),
        jnp.where(saturated, q_sat.liquid, 0.0),
        jnp.where(saturated, q_sat.ice, 0.0),
    )
    return T, q


def density_saturation_adjust(theta_li, rho, qt, constants: ThermodynamicConstants,
                              scheme: "SaturationAdjustment",
                              p_standard: float = 1.0e5):
    """Density-consistent saturation adjustment for compressible dynamics.

    Mirrors the reference's ``LiquidIceDensityState`` pathway
    (``saturation_adjustment.jl:236-290``): qsat and the θˡⁱ inversion are
    evaluated at the state's actual density ρ (with true pressure p = ρRᵐT)
    rather than a fixed reference pressure.  The single residual

        r(T) = θˡⁱ(T; q_eq(T, ρ)) − θ₀

    covers both branches (unsaturated cells get q_eq = all-vapor because
    qᵗ < qᵛ⁺).  Returns ``(T, q, p)``.
    """
    from .microphysics import equilibrated_moisture_fractions  # self-import ok

    eq = scheme.equilibrium
    Ll = constants.liquid.reference_latent_heat
    Li = constants.ice.reference_latent_heat

    def partition(T):
        lam = eq.liquid_fraction(T)
        qvs = saturation_specific_humidity(T, rho, constants, lam)
        qvs = jnp.minimum(qvs, jnp.maximum(qt, 0.0) + 1.0)  # guard
        return equilibrated_moisture_fractions(T, qt, qvs, eq)

    def theta_of(T):
        q = partition(T)
        Rm = constants.mixture_gas_constant(q)
        cpm = constants.mixture_heat_capacity(q)
        p = rho * Rm * T
        kappa = Rm / cpm
        return (T - (Ll * q.liquid + Li * q.ice) / cpm) * (p_standard / p) ** kappa

    def residual(T):
        return theta_of(T) - theta_li

    # initial guesses: dry inversion, then a latent-heat bump
    Rd = constants.Rd
    cpd = constants.dry_air.heat_capacity
    # dry closed form: T = θ (ρRdθ/pst)^(Rd/cvd)
    cvd = cpd - Rd
    T1 = theta_li * (rho * Rd * theta_li / p_standard) ** (Rd / cvd)
    T2 = T1 + 1.0

    Ta, Tb = T1, T2
    ra = residual(Ta)
    # Secant regardless of scheme.solver (the θ(T; ρ) residual's analytic
    # slope needs the EOS pressure feedback — not yet derived); trip count
    # pinned at 7 = the pre-Newton default (iterations=5) + 2.
    for _ in range(max(scheme.iterations + 2, 7)):
        rb = residual(Tb)
        dr = rb - ra
        safe = jnp.where(jnp.abs(dr) > 1e-30, dr, jnp.ones_like(dr))
        Tc = jnp.where(jnp.abs(dr) > 1e-30, Tb - rb * (Tb - Ta) / safe, Tb)
        Ta, ra, Tb = Tb, rb, Tc

    T = Tb
    q = partition(T)
    p = rho * constants.mixture_gas_constant(q) * T
    return T, q, p


def density_saturation_adjust_static_energy(e, z, rho, qt,
                                            constants: ThermodynamicConstants,
                                            scheme: "SaturationAdjustment"):
    """Density-consistent saturation adjustment for the static-energy
    formulation on the compressible core.

    Static-energy analogue of :func:`density_saturation_adjust` (reference
    ``StaticEnergyState`` + ``CompressibleDynamics``; the reference's own
    compressible+ρe diagnostic dispatch is absent —
    ``compressible_time_stepping.jl:216-252`` defines ``temperature_and_
    pressure`` for the θˡⁱ formulation only — so this is the completed
    design): solve the fixed point

        T = (e − gz + ℒˡqˡ(T) + ℒⁱqⁱ(T)) / cᵖᵐ(q(T))

    with the equilibrium partition evaluated at the TRUE density,
    qᵛ⁺ = pᵛ⁺(T)/(ρRᵛT) — no pressure iteration needed (the density form
    of qsat closes without p).  Returns ``(T, q, p)`` with p = ρRᵐT.
    """
    from ..thermo.states import temperature_from_static_energy

    eq = scheme.equilibrium

    def partition(T):
        lam = eq.liquid_fraction(T)
        qvs = saturation_specific_humidity(T, rho, constants, lam)
        qvs = jnp.minimum(qvs, jnp.maximum(qt, 0.0) + 1.0)  # guard
        return equilibrated_moisture_fractions(T, qt, qvs, eq)

    def residual(T):
        return T - temperature_from_static_energy(e, z, partition(T),
                                                  constants)

    q1 = MoistureMassFractions.vapor_only(qt)
    T1 = temperature_from_static_energy(e, z, q1, constants)
    lam1 = eq.liquid_fraction(T1)
    qvs1 = saturation_specific_humidity(T1, rho, constants, lam1)
    saturated = qt > qvs1

    Ta, Tb = T1, T1 + 1.0
    ra = residual(Ta)
    for _ in range(max(scheme.iterations + 2, 7)):
        rb = residual(Tb)
        dr = rb - ra
        safe = jnp.where(jnp.abs(dr) > 1e-30, dr, jnp.ones_like(dr))
        Tc = jnp.where(jnp.abs(dr) > 1e-30, Tb - rb * (Tb - Ta) / safe, Tb)
        Ta, ra, Tb = Tb, rb, Tc

    q_sat = partition(Tb)
    T = jnp.where(saturated, Tb, T1)
    q = MoistureMassFractions(
        jnp.where(saturated, q_sat.vapor, q1.vapor),
        jnp.where(saturated, q_sat.liquid, 0.0),
        jnp.where(saturated, q_sat.ice, 0.0),
    )
    p = rho * constants.mixture_gas_constant(q) * T
    return T, q, p


def density_temperature_inversion(theta_li, rho, q, constants,
                                  p_standard: float = 1.0e5,
                                  iterations: int = 5):
    """Invert θˡⁱ(T) = θ₀ at FIXED moisture partition q and density ρ.

    The compressible-path analogue of ``temperature_from_theta_li`` for
    prognostic-condensate schemes (Kessler, 1M/2M): pressure is the true
    EOS pressure p = ρRᵐT rather than a reference column (reference
    ``LiquidIceDensityState`` with grid moisture fractions,
    ``compressible_time_stepping.jl:161-244``).  Returns ``(T, p)``.
    """
    Rm = constants.mixture_gas_constant(q)
    cpm = constants.mixture_heat_capacity(q)
    Ll = constants.liquid.reference_latent_heat
    Li = constants.ice.reference_latent_heat
    kappa = Rm / cpm
    lheat = (Ll * q.liquid + Li * q.ice) / cpm

    def residual(T):
        p = rho * Rm * T
        return (T - lheat) * (p_standard / p) ** kappa - theta_li

    # dry-ish closed-form seed: T = θ (ρRmθ/pst)^(Rm/cvm)
    cvm = cpm - Rm
    T1 = theta_li * (rho * Rm * theta_li / p_standard) ** (Rm / cvm)
    Ta, Tb = T1, T1 + 1.0
    ra = residual(Ta)
    for _ in range(iterations + 1):
        rb = residual(Tb)
        dr = rb - ra
        safe = jnp.where(jnp.abs(dr) > 1e-30, dr, jnp.ones_like(dr))
        Tc = jnp.where(jnp.abs(dr) > 1e-30, Tb - rb * (Tb - Ta) / safe, Tb)
        Ta, ra, Tb = Tb, rb, Tc
    T = Tb
    return T, rho * Rm * T


@dataclasses.dataclass(frozen=True)
class InstantaneousPrecipitation:
    """Saturation adjustment + instant removal of condensate.

    Analogue of reference ``src/Microphysics/instantaneous_precipitation.jl``
    (:38-182): each step (operator-split), condensate diagnosed by the
    embedded saturation adjustment is removed from the column; θˡⁱ is
    re-expressed for the condensate-free state at unchanged temperature.
    """

    equilibrium: object = dataclasses.field(default_factory=WarmPhaseEquilibrium)
    iterations: int = 5

    def model_update(self, model, state, dt):
        from ..thermo.states import theta_li_from_temperature

        c = model.constants
        scheme = SaturationAdjustment(self.equilibrium, self.iterations)
        rho_state = getattr(state, "rho", None)
        if rho_state is not None:
            # Compressible: TRUE density; (T, q, p) from the density-based
            # saturation adjustment (the reference's LiquidIceDensityState
            # path).  Rain-out removes condensate MASS from the total-ρ
            # prognostic (the reference's ρᵈ prognostic is untouched by
            # removal; ours is total, so ρ ← ρ(1 − qᶜ)).
            rho = rho_state
            qt = state.rho_qt / rho
            if getattr(model, "formulation", None) == "static_energy":
                # ρe slot: adjust at the true density, rain out condensate
                # mass, and rebuild e from (T, vapor-only q) — e is NOT
                # invariant under removal (it carries −ℒˡqˡ and the cᵖᵐ
                # composition weight).
                from ..thermo.states import static_energy
                e = state.rho_theta / rho
                z = model.grid.z_c_col
                T, q, p = density_saturation_adjust_static_energy(
                    e, z, rho, qt, c, scheme)
                qc = q.liquid + q.ice
                rho_new = rho * (1.0 - qc)
                qv_new = q.vapor / (1.0 - qc)
                q_dry = MoistureMassFractions.vapor_only(qv_new)
                e_new = static_energy(T, z, q_dry, c)
                return state.replace(
                    rho=rho_new,
                    rho_qt=rho * q.vapor,
                    rho_theta=rho_new * e_new,
                )
            theta = state.rho_theta / rho
            T, q, p = density_saturation_adjust(theta, rho, qt, c, scheme,
                                                model.p_standard)
            qc = q.liquid + q.ice
            rho_new = rho * (1.0 - qc)
            qv_new = q.vapor / (1.0 - qc)
            q_dry = MoistureMassFractions.vapor_only(qv_new)
            theta_new = theta_li_from_temperature(T, q_dry, p, c,
                                                  model.p_standard)
            return state.replace(
                rho=rho_new,
                rho_qt=rho * q.vapor,
                rho_theta=rho_new * theta_new,
            )
        ref = model.reference
        rho = ref.rho_col
        p = ref.p_col
        theta = state.rho_theta / rho
        qt = state.rho_qt / rho
        T, q = saturation_adjust(theta, qt, p, c, scheme, model.p_standard)
        q_dry = MoistureMassFractions.vapor_only(q.vapor)
        theta_new = theta_li_from_temperature(T, q_dry, p, c, model.p_standard)
        return state.replace(
            rho_qt=rho * q.vapor,
            rho_theta=rho * theta_new,
        )


def fix_negative_moisture(rho_q, dz_col=None):
    """Δz-weighted vertical-borrowing repair of negative moisture.

    Analogue of reference ``negative_moisture_correction.jl``
    (`VerticalBorrowing` :50, ``vertical_borrow!`` :244-286): works in
    column mass-per-area units ``m = ρq·Δz`` so that the column integral
    ∫ρq dz is conserved exactly on stretched grids.  A top→bottom ``scan``
    pushes each level's deficit into the level below; if the bottom level is
    still negative it borrows ``min(needed, available)`` from the level
    above.  A residual negative (the column integral itself is negative)
    stays in place — exactly the reference's conservative behavior.

    ``dz_col`` is the cell-thickness column, shape ``(nz, 1, 1)``;
    pass ``None`` for uniform spacing (weights cancel).
    """
    import jax

    nz = rho_q.shape[0]
    m = rho_q if dz_col is None else rho_q * dz_col
    if nz == 1:
        return rho_q

    # Top→bottom deficit push in closed form.  The sequential recurrence
    #   newⱼ = aⱼ + cⱼ₋₁,  outⱼ = max(newⱼ, 0),  cⱼ = min(newⱼ, 0)
    # telescopes to newⱼ = Sⱼ − max(0, max_{i<j} Sᵢ) with S = cumsum(a) —
    # two log-depth cumulative ops instead of an nz-step lax.scan (whose
    # cost is pure sequential latency).
    a = m[:0:-1]                      # levels nz-1 .. 1, scan order
    S = jnp.cumsum(a, axis=0)
    M = jnp.maximum(jax.lax.cummax(S, axis=0), 0.0)
    Mprev = jnp.concatenate([jnp.zeros_like(M[:1]), M[:-1]], axis=0)
    new = S - Mprev
    out_rev = jnp.maximum(new, 0.0)
    carry = jnp.minimum(new[-1], 0.0)
    m_upper = out_rev[::-1]          # levels 1..nz-1, now nonnegative
    m0 = m[0] + carry
    # bottom-to-top borrow: bottom takes what level 1 can spare
    take = jnp.where(m0 < 0, jnp.minimum(-m0, jnp.maximum(m_upper[0], 0.0)), 0.0)
    m0 = m0 + take
    m_upper = m_upper.at[0].add(-take)
    out = jnp.concatenate([m0[None], m_upper], axis=0)
    return out if dz_col is None else out / dz_col


def species_borrow(chain, rho_qve):
    """Same-level species borrowing (reference ``SpeciesBorrowing``,
    ``negative_moisture_correction.jl:290-318``).

    ``chain`` is a sequence of ρq arrays ordered heaviest→lightest
    hydrometeor; each negative entry borrows from the next lighter species,
    the lightest borrows from the vapor/equilibrium-moisture prognostic
    ``rho_qve``.  Same-level transfers cancel the density factor, so the
    chain operates directly on ρq.  Returns ``(new_chain, new_rho_qve)``.
    """
    chain = list(chain)
    for i, heavy in enumerate(chain):
        light = chain[i + 1] if i + 1 < len(chain) else rho_qve
        sink = jnp.where(heavy < 0.0,
                         jnp.minimum(-heavy, jnp.maximum(light, 0.0)), 0.0)
        chain[i] = heavy + sink
        if i + 1 < len(chain):
            chain[i + 1] = light - sink
        else:
            rho_qve = light - sink
    return chain, rho_qve


def apply_negative_moisture_correction(model, state):
    """Full negative-moisture repair pass (reference
    ``fix_negative_moisture!``, ``negative_moisture_correction.jl:172-221``):

    1. same-level species borrowing heavy→light into the moisture prognostic,
    2. orphaned number-concentration zeroing + negative-number clamping,
    3. Δz-weighted vertical borrowing of the moisture prognostic.
    """
    if state.rho_qt is None:
        return state
    dz_col = model.grid.dz_c_col
    tracers = dict(state.tracers)
    rho_qt = state.rho_qt

    scheme = model.microphysics
    chain_names = [n for n in getattr(scheme, "correction_tracer_chain", ())
                   if n in tracers]
    if chain_names:
        chain, rho_qt = species_borrow([tracers[n] for n in chain_names], rho_qt)
        for n, v in zip(chain_names, chain):
            tracers[n] = v

    # number-concentration consistency (reference :327-347)
    for n_name, q_name in getattr(scheme, "correction_number_mass_pairs", ()):
        if n_name in tracers and q_name in tracers:
            tracers[n_name] = jnp.where(tracers[q_name] <= 0.0, 0.0,
                                        tracers[n_name])
    for n_name in getattr(scheme, "correction_number_fields", ()):
        if n_name in tracers:
            tracers[n_name] = jnp.maximum(tracers[n_name], 0.0)

    # Purely columnar → unchanged under any horizontal decomposition.
    rho_qt = fix_negative_moisture(rho_qt, dz_col)
    # hydrometeor masses not on the borrowing chain still get the
    # conservative vertical sweep (pre-round-2 behavior, now Δz-weighted)
    for k in list(tracers):
        if k.startswith("rho_q") and k not in chain_names:
            tracers[k] = fix_negative_moisture(tracers[k], dz_col)
    return state.replace(rho_qt=rho_qt, tracers=tracers)


def saturation_adjust(theta_li, qt, p, constants: ThermodynamicConstants,
                      scheme: SaturationAdjustment,
                      p_standard: float = 1.0e5, T_guess=None):
    """Saturation-adjusted (T, q) from prognostic (θˡⁱ, qᵗ) at pressure p.

    Follows the reference's algorithm (:193-235): unsaturated first guess,
    latent-heat-scaled second guess, then a fixed-count secant on the
    temperature residual  r(T) = T − T(θˡⁱ, q_eq(T), p).

    ``T_guess`` (Newton solver only): a warm-start temperature — e.g. the
    previous RK3 stage's converged T — replaces the latent-overshoot
    second guess and drops the trip count to ``scheme.warm_iterations``
    (the guess chain + one trip of transcendental work per point).

    Returns ``(T, MoistureMassFractions)``.
    """
    eq = scheme.equilibrium

    # Unsaturated guess: all moisture is vapor.
    q1 = MoistureMassFractions.vapor_only(qt)
    T1 = temperature_from_theta_li(theta_li, q1, p, constants, p_standard)
    lam1 = eq.liquid_fraction(T1)
    rho1 = constants.density(T1, p, q1)
    qvs1 = saturation_specific_humidity(T1, rho1, constants, lam1)
    saturated = qt > qvs1

    def residual(T):
        lam = eq.liquid_fraction(T)
        qvs = adjustment_saturation_specific_humidity(T, p, qt, constants, lam)
        q = equilibrated_moisture_fractions(T, qt, qvs, eq)
        T_back = temperature_from_theta_li(theta_li, q, p, constants, p_standard)
        return T - T_back

    if scheme.solver == "newton" and T_guess is not None:
        # Warm start: skip the second-guess chain entirely.  Where the
        # point was unsaturated last stage (T_guess ≈ its old T1) the
        # saturated-branch root satisfies T* ≥ T1 for condensational
        # warming, so max(T_guess, T1 + 0.01) is on the right side.
        T_start = jnp.maximum(T_guess, T1 + 0.01)
        T_star, qvs_s = _newton_adjust_T_theta_li(
            T_start, qt, p, theta_li, constants, eq,
            scheme.warm_iterations, p_standard)
        q_sat = equilibrated_moisture_fractions(T_star, qt, qvs_s, eq)
        T = jnp.where(saturated, T_star, T1)
        q = MoistureMassFractions(
            jnp.where(saturated, q_sat.vapor, q1.vapor),
            jnp.where(saturated, q_sat.liquid, 0.0),
            jnp.where(saturated, q_sat.ice, 0.0),
        )
        return T, q

    # Second guess: a damped Newton step from T1.  The latent warming the
    # all-vapor state implies is dT = (ℒˡqˡ + ℒⁱqⁱ)/cᵖᵐ ≈ −r(T1); dividing
    # by the analytic residual slope (which reuses qvs_a — no extra svp
    # evaluation) instead of halving lands an order of magnitude closer
    # than the previous 0.5·dT heuristic.
    lam = eq.liquid_fraction(T1)
    qvs_a = adjustment_saturation_specific_humidity(T1, p, qt, constants, lam)
    qa = equilibrated_moisture_fractions(T1, qt, qvs_a, eq)
    cpm = constants.mixture_heat_capacity(qa)
    Ll = constants.liquid.reference_latent_heat
    Li = constants.ice.reference_latent_heat
    dT = (Ll * qa.liquid + Li * qa.ice) / cpm
    L_eff1 = lam * Ll + (1.0 - lam) * Li
    pvs_a = saturation_vapor_pressure(T1, constants, lam)
    dqvs1 = (qvs_a * saturation_vapor_pressure_slope_ratio(T1, constants, lam)
             * p / (p - pvs_a))
    T2 = T1 + jnp.maximum(0.01, dT / (1.0 + L_eff1 * dqvs1 / cpm))

    qvs_newton = None
    if scheme.solver == "newton":
        T_star, qvs_newton = _newton_adjust_T_theta_li(
            T2, qt, p, theta_li, constants, eq, scheme.iterations,
            p_standard)
    else:
        # Fixed-count secant from (T1, T2).
        Ta, Tb = T1, T2
        ra = residual(Ta)
        for _ in range(scheme.iterations):
            rb = residual(Tb)
            dr = rb - ra
            safe = jnp.where(jnp.abs(dr) > 0, dr, jnp.ones_like(dr))
            Tc = jnp.where(jnp.abs(dr) > 0, Tb - rb * (Tb - Ta) / safe, Tb)
            Ta, ra, Tb = Tb, rb, Tc
        T_star = Tb
    if qvs_newton is not None:
        qvs_s = qvs_newton
    else:
        lam_s = eq.liquid_fraction(T_star)
        qvs_s = adjustment_saturation_specific_humidity(T_star, p, qt,
                                                        constants, lam_s)
    q_sat = equilibrated_moisture_fractions(T_star, qt, qvs_s, eq)

    T = jnp.where(saturated, T_star, T1)
    q = MoistureMassFractions(
        jnp.where(saturated, q_sat.vapor, q1.vapor),
        jnp.where(saturated, q_sat.liquid, 0.0),
        jnp.where(saturated, q_sat.ice, 0.0),
    )
    return T, q
