"""Saturation vapor pressure closures and phase equilibria.

Equivalent of reference ``src/Thermodynamics/{clausius_clapeyron,
flatau_polynomial, tetens_formula, vapor_saturation}.jl``.  All functions are
pointwise jnp expressions — XLA fuses them into the surrounding kernels (the
reference's motivation for the Flatau fit, avoiding ``^``/``exp`` inside the
saturation-adjustment iteration, applies here too: Horner evaluation is
pure multiply-add work).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .constants import MoistureMassFractions, ThermodynamicConstants

# ---------------------------------------------------------------------------
# Surfaces: what the vapor is equilibrating against.
# A surface is represented by its liquid fraction lam in [0, 1]:
# lam = 1 -> planar liquid, lam = 0 -> planar ice, else mixed phase
# (reference vapor_saturation.jl:5-37).
# ---------------------------------------------------------------------------

LIQUID_SURFACE = 1.0
ICE_SURFACE = 0.0


def _mixed_latent_heat_params(constants: ThermodynamicConstants, lam):
    """Effective (L0, dc) for a mixed-phase surface with liquid fraction lam."""
    L0l = constants.absolute_zero_latent_heat(constants.liquid)
    L0i = constants.absolute_zero_latent_heat(constants.ice)
    dcl = constants.specific_heat_difference(constants.liquid)
    dci = constants.specific_heat_difference(constants.ice)
    L0 = lam * L0l + (1.0 - lam) * L0i
    dc = lam * dcl + (1.0 - lam) * dci
    return L0, dc


def clausius_clapeyron_svp(T, constants: ThermodynamicConstants, lam=LIQUID_SURFACE):
    """Integrated Clausius-Clapeyron saturation vapor pressure (docs eq.).

    ``p = p_tr (T/T_tr)^(dc/Rv) exp[(L0/Rv)(1/T_tr - 1/T)]``
    """
    L0, dc = _mixed_latent_heat_params(constants, lam)
    Rv = constants.Rv
    Ttr = constants.triple_point_temperature
    ptr = constants.triple_point_pressure
    return ptr * (T / Ttr) ** (dc / Rv) * jnp.exp((L0 / Rv) * (1.0 / Ttr - 1.0 / T))


# Flatau et al. (1992) relative-error-norm coefficients
# (reference flatau_polynomial.jl:62-69); x = T - 273.16, Horner form.
_FLATAU_LIQUID = (611.239921, 44.3987641, 1.42986287,
                  2.64847430e-2, 3.02950461e-4, 2.06739458e-6,
                  6.40689451e-9, -9.52447341e-12, -9.76195544e-14)
_FLATAU_ICE = (611.147274, 50.3160820, 1.88439774,
               4.20895665e-2, 6.15021634e-4, 6.02588177e-6,
               3.85852041e-8, 1.46898966e-10, 2.52751365e-13)
_FLATAU_T_REF = 273.16


def _horner(x, coeffs):
    acc = jnp.zeros_like(x) + coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = acc * x + c
    return acc


def flatau_svp(T, constants: ThermodynamicConstants, lam=LIQUID_SURFACE):
    """Flatau polynomial fit; mixed-phase surfaces blend liquid/ice fits."""
    x = T - _FLATAU_T_REF
    pl = _horner(x, _FLATAU_LIQUID)
    pi_ = _horner(x, _FLATAU_ICE)
    if isinstance(lam, float):
        if lam == 1.0:
            return pl
        if lam == 0.0:
            return pi_
    return lam * pl + (1.0 - lam) * pi_


@dataclasses.dataclass(frozen=True)
class TetensParams:
    """Tetens (1930) empirical fit (reference tetens_formula.jl:1-150)."""

    reference_svp: float = 610.0
    reference_temperature: float = 273.15
    liquid_coefficient: float = 17.27
    liquid_temperature_offset: float = 35.85
    ice_coefficient: float = 21.875
    ice_temperature_offset: float = 7.65


def tetens_svp(T, constants: ThermodynamicConstants, lam=LIQUID_SURFACE,
               params: TetensParams = TetensParams()):
    Tr = params.reference_temperature
    pvr = params.reference_svp
    pl = pvr * jnp.exp(params.liquid_coefficient * (T - Tr) / (T - params.liquid_temperature_offset))
    pi_ = pvr * jnp.exp(params.ice_coefficient * (T - Tr) / (T - params.ice_temperature_offset))
    if isinstance(lam, float):
        if lam == 1.0:
            return pl
        if lam == 0.0:
            return pi_
    return lam * pl + (1.0 - lam) * pi_


def saturation_vapor_pressure_slope_ratio(T, constants: ThermodynamicConstants,
                                          lam=LIQUID_SURFACE):
    """(dpᵛ⁺/dT) / pᵛ⁺ = (L₀ + Δc·T) / (Rᵛ T²).

    Exact for the Clausius-Clapeyron closure and an excellent approximation
    for the Flatau/Tetens fits (they fit the same curve); used as the
    analytic Newton slope in saturation adjustment, where an approximate
    Jacobian only perturbs the convergence path, not the root."""
    L0, dc = _mixed_latent_heat_params(constants, lam)
    return (L0 + dc * T) / (constants.Rv * T * T)


_SVP_FORMULATIONS = {
    "clausius_clapeyron": clausius_clapeyron_svp,
    "flatau": flatau_svp,
    "tetens": tetens_svp,
}


def saturation_vapor_pressure(T, constants: ThermodynamicConstants, lam=LIQUID_SURFACE):
    """Dispatch on ``constants.saturation_formulation``."""
    return _SVP_FORMULATIONS[constants.saturation_formulation](T, constants, lam)


# ---------------------------------------------------------------------------
# Phase equilibria (reference vapor_saturation.jl:130-200)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WarmPhaseEquilibrium:
    """Only liquid condensate; the equilibrated surface is planar liquid."""

    def liquid_fraction(self, T):
        return 1.0


@dataclasses.dataclass(frozen=True)
class MixedPhaseEquilibrium:
    """Liquid fraction ramps linearly between homogeneous-nucleation and
    freezing temperatures (reference vapor_saturation.jl:157-200)."""

    freezing_temperature: float = 273.15
    homogeneous_ice_nucleation_temperature: float = 233.15

    def liquid_fraction(self, T):
        Tf = self.freezing_temperature
        Th = self.homogeneous_ice_nucleation_temperature
        return jnp.clip((T - Th) / (Tf - Th), 0.0, 1.0)

    def partition(self, T, q_condensate):
        lam = self.liquid_fraction(T)
        return lam * q_condensate, (1.0 - lam) * q_condensate


# ---------------------------------------------------------------------------
# Saturation specific humidity
# ---------------------------------------------------------------------------

def saturation_specific_humidity(T, rho, constants: ThermodynamicConstants,
                                 lam=LIQUID_SURFACE):
    """qᵛ⁺ = pᵛ⁺ / (ρ Rᵛ T) (reference vapor_saturation.jl:93-105)."""
    pvs = saturation_vapor_pressure(T, constants, lam)
    return pvs / (rho * constants.Rv * T)


def equilibrium_saturation_specific_humidity(T, p, qt, constants: ThermodynamicConstants,
                                             lam=LIQUID_SURFACE):
    """Closed-form qᵛ⁺(T, p, qᵗ) selecting saturated/unsaturated branches.

    Saturated (condensate present, Pressel 2015 eq. 37):
      ``qᵛ⁺ = ε (1 − qᵗ) pᵛ⁺ / (p − pᵛ⁺)``
    Unsaturated: density-based formula with ``Rᵐ = (1−qᵗ)Rᵈ + qᵗRᵛ``.
    (reference vapor_saturation.jl:216-240)
    """
    pvs = saturation_vapor_pressure(T, constants, lam)
    Rd, Rv = constants.Rd, constants.Rv
    eps = Rd / Rv
    q_sat_branch = eps * (1.0 - qt) * pvs / (p - pvs)

    Rm = Rd * (1.0 - qt) + Rv * qt
    rho = p / (Rm * T)
    q_unsat_branch = pvs / (rho * Rv * T)

    return jnp.where(qt >= q_unsat_branch, q_sat_branch, q_unsat_branch)


def supersaturation(T, rho, q: MoistureMassFractions, constants, lam=LIQUID_SURFACE):
    """S = pᵛ/pᵛ⁺ − 1 (reference vapor_saturation.jl:107-127)."""
    pvs = saturation_vapor_pressure(T, constants, lam)
    pv = constants.vapor_pressure(T, rho, q.vapor)
    return pv / pvs - 1.0
