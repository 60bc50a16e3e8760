"""Standalone bulk-microphysics framework options.

Non-equilibrium cloud formation: cloud liquid (and optionally cloud ice)
are PROGNOSTIC tracers that relax toward saturation instead of being
diagnosed instantaneously (reference ``src/Microphysics/bulk_microphysics.jl:44-90``,
Morrison & Grabowski 2008 Appendix Eq. A3).  The condensation /
deposition tendencies carry the psychrometric correction factor
Γ = 1 + (ℒ/cᵖᵐ)·dqᵛ⁺/dT so the linearized fixed point is the
saturation-adjusted state (``bulk_microphysics.jl:115-173``).

:class:`ConstantRateCondensateFormation` mirrors the reference option of
the same name (``bulk_microphysics.jl:94-105``): its ``rate`` field stores
the constant relaxation *rate coefficient* 1/τ_relax [1/s] (the reference
inverts it back into a timescale, ``one_moment_microphysics.jl:496-501``).

Shape: the whole-grid update is one fused elementwise pass applied
operator-split after RK3 stage 3 (same hook as Kessler/1M); θˡⁱ is
invariant under the phase changes, so only the moisture categories move
and T adjusts through the diagnostic relation.
"""

from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp

from ..thermo.constants import MoistureMassFractions
from ..thermo.saturation import saturation_specific_humidity
from ..thermo.states import temperature_from_theta_li
from .one_moment import condensation_rate, deposition_rate


@dataclasses.dataclass(frozen=True)
class ConstantRateCondensateFormation:
    """Condensate formation at a constant relaxation rate 1/τ_relax [1/s].

    Usable for both liquid (condensation/evaporation) and ice
    (deposition/sublimation); reference ``bulk_microphysics.jl:94-105``.
    """

    rate: float = 0.1   # 1/s  (τ_relax = 10 s, the MG2008 default)

    @property
    def tau_relax(self) -> float:
        # rate == 0 is a legal phase-indicator instance in the reference
        # (condensate_formation_from_option(::Nothing) builds a zero-rate
        # scheme); an infinite timescale makes every tendency exactly 0.
        if self.rate == 0.0:
            return math.inf
        return 1.0 / self.rate


@dataclasses.dataclass(frozen=True)
class NonEquilibriumCloudFormation:
    """Prognostic-condensate cloud formation (reference
    ``bulk_microphysics.jl:44-90``).

    ``liquid`` / ``ice`` are condensate-formation models carrying the
    relaxation timescale (``ice=None`` = warm phase only).  This is the
    standalone, non-precipitating bulk scheme: prognostics are vapor (the
    model moisture slot) plus ``rho_qcl`` (and ``rho_qci``); there are no
    collision or sedimentation processes — pair with the 1M/2M schemes
    when precipitation categories are needed.
    """

    liquid: ConstantRateCondensateFormation = ConstantRateCondensateFormation()
    ice: ConstantRateCondensateFormation | None = None

    surface_diagnostic_names = ()

    @property
    def prognostic_tracer_names(self):
        if self.ice is None:
            return ("rho_qcl",)
        return ("rho_qcl", "rho_qci")

    liquid_tracer_names = ("rho_qcl",)

    @property
    def ice_tracer_names(self):
        return () if self.ice is None else ("rho_qci",)

    @property
    def correction_tracer_chain(self):
        # condensate borrows into vapor, ice before liquid (heavier first;
        # reference correction_moisture_fields ordering)
        if self.ice is None:
            return ("rho_qcl",)
        return ("rho_qci", "rho_qcl")

    def model_update(self, model, state, dt):
        # no subcycle counts derive from dt, so it may stay traced
        return non_equilibrium_update(self, model, state, dt)


def non_equilibrium_update(scheme: NonEquilibriumCloudFormation, model,
                           state, dt):
    """One operator-split relaxation step on the whole grid.

    Anelastic states use the reference column (ρᵣ, pᵣ); compressible
    states (``state.rho`` present) use the true density with the
    fixed-partition θˡⁱ temperature inversion (same dispatch as
    Kessler/1M).  The forward-Euler increment is clamped at the
    Γ-corrected equilibrium so a dt ≫ τ step lands on (not past) the
    saturation-adjusted state, and evaporation/sublimation can never
    consume more condensate than exists (reference limits,
    ``bulk_microphysics.jl:152-173``).
    """
    g = model.grid
    c = model.constants
    ref = model.reference

    rho_state = getattr(state, "rho", None)
    if rho_state is not None:
        from .microphysics import density_temperature_inversion
        rho = rho_state
        p = None
    else:
        rho = jnp.broadcast_to(ref.rho_col, g.shape).astype(g.dtype)
        p = jnp.broadcast_to(ref.p_col, g.shape).astype(g.dtype)

    zeros = jnp.zeros(g.shape, g.dtype)
    qv_raw = state.rho_qt / rho
    qv = jnp.maximum(qv_raw, 0.0)
    qcl = jnp.maximum(state.tracers.get("rho_qcl", zeros) / rho, 0.0)
    qci = jnp.maximum(state.tracers.get("rho_qci", zeros) / rho, 0.0)
    theta = state.rho_theta / rho

    q = MoistureMassFractions(qv, qcl, qci)
    if p is not None:
        T = temperature_from_theta_li(theta, q, p, c, model.p_standard)
    else:
        from .microphysics import density_temperature_inversion
        T, _ = density_temperature_inversion(theta, rho, q, c,
                                             model.p_standard)

    # --- condensation / evaporation (vapor <-> cloud liquid) -----------
    qvs = saturation_specific_humidity(T, rho, c, 1.0)
    S_cond = condensation_rate(qv, qvs, qcl, T, q,
                               scheme.liquid.tau_relax, c)
    d_cond = _clamped_increment(S_cond, scheme.liquid.tau_relax, qcl, dt)

    if scheme.ice is not None:
        qvsi = saturation_specific_humidity(T, rho, c, 0.0)
        S_dep = deposition_rate(qv, qvsi, qci, T, q,
                                scheme.ice.tau_relax, c)
        # no warm-rain deposition growth above freezing
        S_dep = jnp.where((T > c.triple_point_temperature) & (S_dep > 0.0),
                          0.0, S_dep)
        d_dep = _clamped_increment(S_dep, scheme.ice.tau_relax, qci, dt)
    else:
        d_dep = zeros

    # Closed moisture budget.  Condensation and deposition were computed
    # independently from the SAME vapor, so in mixed-phase conditions their
    # positive parts can overdraw qv; rescale the positive increments
    # proportionally (the tendencies compete for the same supersaturation,
    # reference ``bulk_microphysics.jl:147-173`` semantics) instead of
    # clamping vapor at zero, which would create moisture.
    pos = jnp.maximum(d_cond, 0.0) + jnp.maximum(d_dep, 0.0)
    scale = jnp.where(pos > qv, qv / jnp.maximum(pos, jnp.finfo(g.dtype).tiny),
                      1.0)
    d_cond = jnp.where(d_cond > 0.0, d_cond * scale, d_cond)
    d_dep = jnp.where(d_dep > 0.0, d_dep * scale, d_dep)

    # _clamped_increment bounds the negative side at -q_cat and the scaling
    # bounds the positive side at qv, so qv1 + qcl1 + qci1 == qv + qcl + qci
    # to rounding; the max() only absorbs the 1-ulp residual of the rescale
    # (full-drain case: qv - pos*(qv/pos) can land one ulp below zero).
    qcl1 = qcl + d_cond
    qci1 = qci + d_dep
    qv1 = jnp.maximum(qv - d_cond - d_dep, 0.0)

    # Carry any negative incoming rho_qt (advection undershoot) through
    # unchanged — erasing it here would create moisture; repair belongs to
    # the negative-moisture correction at step start.
    qv1 = qv1 + jnp.minimum(qv_raw, 0.0)

    tracers = dict(state.tracers)
    tracers["rho_qcl"] = rho * qcl1
    if scheme.ice is not None:
        tracers["rho_qci"] = rho * qci1
    return state.replace(rho_qt=rho * qv1, tracers=tracers)


def _clamped_increment(S, tau, q_cat, dt):
    """Forward-Euler increment S·dt clamped at (a) the linearized
    equilibrium offset |S|·τ (S = (qᵛ−qᵛ⁺)/(Γτ) and the fixed point of
    the linearized relaxation sits at Δq* = (qᵛ−qᵛ⁺)/Γ = S·τ, so a
    Δt ≫ τ step lands on, not past, the adjusted state) and (b) available
    condensate on the negative side."""
    d = S * jnp.minimum(dt, tau)
    # never consume more condensate than exists
    return jnp.maximum(d, -jnp.maximum(q_cat, 0.0))
