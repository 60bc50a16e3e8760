"""Thermodynamic state relations: potential temperature <-> temperature.

Equivalent of reference ``src/Thermodynamics/dynamic_states.jl``
(`LiquidIcePotentialTemperatureState` :22, `temperature` :69-80,
`StaticEnergyState` :270).  States are not structs here — XLA fuses the
pointwise relations directly; each relation is a plain function of arrays.
"""

from __future__ import annotations

import jax.numpy as jnp

from .constants import MoistureMassFractions, ThermodynamicConstants

DEFAULT_STANDARD_PRESSURE = 1.0e5


def exner_function(p, q: MoistureMassFractions, constants: ThermodynamicConstants,
                   p_standard: float = DEFAULT_STANDARD_PRESSURE):
    """Moist Exner function Π = (p / pˢᵗ)^(Rᵐ/cᵖᵐ).

    Written as ``exp((Rᵐ/cᵖᵐ)·log(p/pˢᵗ))`` rather than ``**`` so the log
    is taken on ``p``'s own (pre-broadcast) shape: on the anelastic path p
    is the (nz,1,1) reference column while Rᵐ/cᵖᵐ is a full field, and the
    generic pow lowering would evaluate a full-field log of a broadcast
    column.  The saturation adjustment calls this inside every Newton trip
    — its cost is its transcendental evaluations, so one hoisted log per
    call is wall time.
    """
    Rm = constants.mixture_gas_constant(q)
    cpm = constants.mixture_heat_capacity(q)
    return jnp.exp((Rm / cpm) * jnp.log(p / p_standard))


def temperature_from_theta_li(theta_li, q: MoistureMassFractions, p,
                              constants: ThermodynamicConstants,
                              p_standard: float = DEFAULT_STANDARD_PRESSURE):
    """T = Π θˡⁱ + (ℒˡᵣ qˡ + ℒⁱᵣ qⁱ) / cᵖᵐ.

    Closed-form inversion of the liquid-ice potential temperature at fixed
    pressure (reference dynamic_states.jl:69-80).
    """
    Pi = exner_function(p, q, constants, p_standard)
    cpm = constants.mixture_heat_capacity(q)
    Ll = constants.liquid.reference_latent_heat
    Li = constants.ice.reference_latent_heat
    return Pi * theta_li + (Ll * q.liquid + Li * q.ice) / cpm


def theta_li_from_temperature(T, q: MoistureMassFractions, p,
                              constants: ThermodynamicConstants,
                              p_standard: float = DEFAULT_STANDARD_PRESSURE):
    """Inverse of :func:`temperature_from_theta_li`."""
    Pi = exner_function(p, q, constants, p_standard)
    cpm = constants.mixture_heat_capacity(q)
    Ll = constants.liquid.reference_latent_heat
    Li = constants.ice.reference_latent_heat
    return (T - (Ll * q.liquid + Li * q.ice) / cpm) / Pi


def static_energy(T, z, q: MoistureMassFractions, constants: ThermodynamicConstants):
    """Moist static energy e = cᵖᵐ T + g z − ℒˡᵣ qˡ − ℒⁱᵣ qⁱ.

    (reference docs anelastic_dynamics.md:49-61, dynamic_states.jl:270)
    """
    cpm = constants.mixture_heat_capacity(q)
    return (cpm * T + constants.gravitational_acceleration * z
            - constants.liquid.reference_latent_heat * q.liquid
            - constants.ice.reference_latent_heat * q.ice)


def temperature_from_static_energy(e, z, q: MoistureMassFractions,
                                   constants: ThermodynamicConstants):
    """Inverse of :func:`static_energy` at fixed composition and height."""
    cpm = constants.mixture_heat_capacity(q)
    return (e - constants.gravitational_acceleration * z
            + constants.liquid.reference_latent_heat * q.liquid
            + constants.ice.reference_latent_heat * q.ice) / cpm
