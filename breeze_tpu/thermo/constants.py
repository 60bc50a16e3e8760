"""Thermodynamic constants and mixture laws for moist air.

Equivalent of the reference's ``src/Thermodynamics/
thermodynamics_constants.jl`` (IdealGas :22, CondensedPhase :51,
ThermodynamicConstants :113, mixture_gas_constant :341,
mixture_heat_capacity :367, density :383).

Constants are plain Python floats held in frozen dataclasses: under ``jit``
they are baked into the compiled program as literals (no HBM traffic, no
tracer overhead) — the XLA analogue of the reference passing an isbits
struct into a CUDA kernel.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class IdealGas:
    molar_mass: float = 0.02897        # kg / mol
    heat_capacity: float = 1005.0      # J / (kg K), at constant pressure


@dataclasses.dataclass(frozen=True)
class CondensedPhase:
    reference_latent_heat: float       # J / kg at the energy reference temperature
    heat_capacity: float               # J / (kg K)


def liquid_water() -> CondensedPhase:
    return CondensedPhase(reference_latent_heat=2_500_800.0, heat_capacity=4181.0)


def water_ice() -> CondensedPhase:
    return CondensedPhase(reference_latent_heat=2_834_000.0, heat_capacity=2108.0)


class MoistureMassFractions(NamedTuple):
    """Mass fractions of vapor / liquid / ice; entries may be arrays.

    Mirrors reference ``MoistureMassFractions`` (constants file :283-300).
    """

    vapor: jax.Array | float
    liquid: jax.Array | float
    ice: jax.Array | float

    @classmethod
    def vapor_only(cls, qv):
        zero = jnp.zeros_like(qv) if hasattr(qv, "shape") else 0.0
        return cls(qv, zero, zero)

    @property
    def total(self):
        return self.vapor + self.liquid + self.ice

    @property
    def dry(self):
        return 1.0 - self.total


@dataclasses.dataclass(frozen=True)
class ThermodynamicConstants:
    """Moist-air constants; defaults match the reference (:425-443)."""

    molar_gas_constant: float = 8.314462618
    gravitational_acceleration: float = 9.81
    energy_reference_temperature: float = 273.15
    triple_point_temperature: float = 273.16
    triple_point_pressure: float = 611.657
    dry_air: IdealGas = dataclasses.field(default_factory=IdealGas)
    vapor: IdealGas = dataclasses.field(
        default_factory=lambda: IdealGas(molar_mass=0.018015, heat_capacity=1850.0))
    liquid: CondensedPhase = dataclasses.field(default_factory=liquid_water)
    ice: CondensedPhase = dataclasses.field(default_factory=water_ice)
    # saturation vapor pressure closure name: "clausius_clapeyron" | "flatau" | "tetens"
    saturation_formulation: str = "clausius_clapeyron"

    # -- gas constants -------------------------------------------------
    @property
    def Rd(self) -> float:
        return self.molar_gas_constant / self.dry_air.molar_mass

    @property
    def Rv(self) -> float:
        return self.molar_gas_constant / self.vapor.molar_mass

    @property
    def epsilon_dv(self) -> float:
        """Rd / Rv ≈ 0.622."""
        return self.Rd / self.Rv

    # -- latent heats (linear in T; reference :233-261) ----------------
    def liquid_latent_heat(self, T):
        dc = self.vapor.heat_capacity - self.liquid.heat_capacity
        return self.liquid.reference_latent_heat + dc * (T - self.energy_reference_temperature)

    def ice_latent_heat(self, T):
        dc = self.vapor.heat_capacity - self.ice.heat_capacity
        return self.ice.reference_latent_heat + dc * (T - self.energy_reference_temperature)

    def specific_heat_difference(self, phase: CondensedPhase) -> float:
        return self.vapor.heat_capacity - phase.heat_capacity

    def absolute_zero_latent_heat(self, phase: CondensedPhase) -> float:
        return (phase.reference_latent_heat
                - self.specific_heat_difference(phase) * self.energy_reference_temperature)

    # -- mixture laws --------------------------------------------------
    def mixture_gas_constant(self, q: MoistureMassFractions):
        """Rᵐ = qᵈ Rᵈ + qᵛ Rᵛ (reference :341-351)."""
        return q.dry * self.Rd + q.vapor * self.Rv

    def mixture_heat_capacity(self, q: MoistureMassFractions):
        """cᵖᵐ = qᵈ cᵖᵈ + qᵛ cᵖᵛ + qˡ cˡ + qⁱ cⁱ (reference :367-380)."""
        return (q.dry * self.dry_air.heat_capacity
                + q.vapor * self.vapor.heat_capacity
                + q.liquid * self.liquid.heat_capacity
                + q.ice * self.ice.heat_capacity)

    def density(self, T, p, q: MoistureMassFractions):
        """Moist ideal gas: ρ = p / (Rᵐ T) (reference :383-386)."""
        return p / (self.mixture_gas_constant(q) * T)

    def vapor_pressure(self, T, rho, qv):
        return rho * qv * self.Rv * T


DRY_Q = MoistureMassFractions(0.0, 0.0, 0.0)
