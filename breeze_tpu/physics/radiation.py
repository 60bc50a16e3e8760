"""Radiative transfer: gray two-stream longwave + shortwave beam, solar geometry.

Equivalent of the reference's radiation stack: the
scheme-agnostic interface (``src/AtmosphereModels/radiation_interface.jl``),
gray RRTMGP model (``ext/BreezeRRTMGPExt/gray_radiative_transfer_model.jl:
66-303``), flux-divergence heating (``rrtmgp_shared_utilities.jl:115-178``),
and solar position types (``src/AtmosphereModels/solar_position.jl``,
``src/CelestialMechanics/solar_zenith_angle.jl:37-156``).

The gray model integrates the two-stream Schwarzschild equations per column
with ``lax.scan`` over z (columns vectorized across (y, x)):

    dF↑/dτ = F↑ − σT⁴,    dF↓/dτ = σT⁴ − F↓

with a height-dependent gray optical depth, plus a Beer–Lambert shortwave
beam.  Heating enters the θ equation as ∇·ℐ/(cᵖᵐ Π)
(reference ``potential_temperature_tendency.jl:100-105``).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

STEFAN_BOLTZMANN = 5.670374419e-8


# ---------------------------------------------------------------------------
# Celestial mechanics (reference solar_zenith_angle.jl)
# ---------------------------------------------------------------------------

def solar_declination(day_of_year):
    """Spencer (1971) Fourier fit for solar declination [rad]."""
    g = 2.0 * math.pi * (day_of_year - 1) / 365.0
    return (0.006918 - 0.399912 * jnp.cos(g) + 0.070257 * jnp.sin(g)
            - 0.006758 * jnp.cos(2 * g) + 0.000907 * jnp.sin(2 * g)
            - 0.002697 * jnp.cos(3 * g) + 0.00148 * jnp.sin(3 * g))


def equation_of_time(day_of_year):
    """Equation of time [minutes] (Spencer 1971)."""
    g = 2.0 * math.pi * (day_of_year - 1) / 365.0
    return 229.18 * (0.000075 + 0.001868 * jnp.cos(g) - 0.032077 * jnp.sin(g)
                     - 0.014615 * jnp.cos(2 * g) - 0.040849 * jnp.sin(2 * g))


def cos_solar_zenith_angle(time_seconds, latitude_deg, longitude_deg=0.0,
                           day_of_year=80):
    """cos(zenith) from UTC seconds-of-day, latitude, longitude.

    Mirrors reference ``cos_solar_zenith_angle`` (declination + equation of
    time + hour angle).  Negative values (sun below horizon) are clamped.
    """
    lat = jnp.deg2rad(latitude_deg)
    decl = solar_declination(day_of_year)
    eot_min = equation_of_time(day_of_year)
    solar_time_min = time_seconds / 60.0 + eot_min + 4.0 * longitude_deg
    hour_angle = jnp.deg2rad(solar_time_min / 4.0 - 180.0)
    mu = (jnp.sin(lat) * jnp.sin(decl)
          + jnp.cos(lat) * jnp.cos(decl) * jnp.cos(hour_angle))
    return jnp.maximum(mu, 0.0)


@dataclasses.dataclass(frozen=True)
class FixedCosineZenith:
    """Constant cos(zenith) (reference solar_position.jl:100)."""

    mu: float = 0.5

    def __call__(self, time):
        return self.mu


@dataclasses.dataclass(frozen=True)
class DiurnalSolarPosition:
    """Diurnal cycle at a fixed location (reference solar_position.jl:155)."""

    latitude: float = 0.0
    longitude: float = 0.0
    day_of_year: int = 80
    start_seconds: float = 0.0

    def __call__(self, time):
        return cos_solar_zenith_angle(self.start_seconds + time, self.latitude,
                                      self.longitude, self.day_of_year)


# ---------------------------------------------------------------------------
# Gray radiation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GrayRadiation:
    """Gray two-stream LW + Beer-Lambert SW as a θ-tendency forcing.

    Parameters mirror the reference gray optics: total longwave optical
    depth ``lw_optical_depth`` distributed ∝ pressure (well-mixed absorber),
    total shortwave depth ``sw_optical_depth``, surface properties, and a
    solar position (callable(time) → μ).

    Applied as a forcing ``(model, state, aux, G) -> G`` (anelastic path).
    """

    lw_optical_depth: float = 4.0
    sw_optical_depth: float = 0.22
    solar_constant: float = 1361.0
    surface_emissivity: float = 1.0
    surface_albedo: float = 0.06
    surface_temperature: float | None = None   # None -> lowest-level T
    solar_position: object = dataclasses.field(default_factory=FixedCosineZenith)

    def fluxes(self, model, aux, time):
        """Return (lw_up, lw_dn, sw_dn) at z-faces 0..nz (shape nz+1)."""
        g = model.grid
        nz = g.nz
        ref = model.reference
        c = model.constants

        # Gray optical depth per layer ∝ Δp (well-mixed absorber):
        p = jnp.broadcast_to(ref.p_col, g.shape)
        p_surf = ref.surface_pressure
        dp = -jnp.gradient(jnp.asarray(ref.p_c))  # (nz,) positive
        dtau = self.lw_optical_depth * dp[:, None, None] / p_surf
        dtau = jnp.broadcast_to(dtau, g.shape)

        T = aux.T
        B = STEFAN_BOLTZMANN * T ** 4

        Ts = (self.surface_temperature if self.surface_temperature is not None
              else T[0])
        B_surf = self.surface_emissivity * STEFAN_BOLTZMANN * Ts ** 4

        # LW up: F(face k+1) = F(face k) e^{-Δτ} + B(1 − e^{-Δτ})
        trans = jnp.exp(-dtau)

        def up_scan(F, inputs):
            t_k, B_k = inputs
            F_new = F * t_k + B_k * (1.0 - t_k)
            return F_new, F_new

        F0 = jnp.broadcast_to(B_surf, g.shape[1:])
        _, lw_up_faces = jax.lax.scan(up_scan, F0, (trans, B))
        lw_up = jnp.concatenate([F0[None], lw_up_faces], axis=0)  # faces 0..nz

        # LW down: from TOA (0) downward
        def dn_scan(F, inputs):
            t_k, B_k = inputs
            F_new = F * t_k + B_k * (1.0 - t_k)
            return F_new, F_new

        Ftop = jnp.zeros(g.shape[1:])
        _, lw_dn_faces = jax.lax.scan(dn_scan, Ftop, (trans[::-1], B[::-1]))
        lw_dn = jnp.concatenate([Ftop[None], lw_dn_faces], axis=0)[::-1]

        # SW beam: cumulative optical path from the top
        mu = jnp.maximum(jnp.asarray(self.solar_position(time)), 1e-3)
        dtau_sw = self.sw_optical_depth * dp[:, None, None] / p_surf
        dtau_sw = jnp.broadcast_to(dtau_sw, g.shape)
        tau_above = jnp.cumsum(dtau_sw[::-1], axis=0)[::-1]
        tau_faces = jnp.concatenate(
            [tau_above, jnp.zeros((1,) + g.shape[1:])], axis=0)
        sw_dn = self.solar_constant * mu * jnp.exp(-tau_faces / mu)

        return lw_up, lw_dn, sw_dn

    def flux_divergence(self, model, aux, time):
        """∇·ℐ at cell centers [W/m³] (net upward flux convention)."""
        g = model.grid
        lw_up, lw_dn, sw_dn = self.fluxes(model, aux, time)
        net = lw_up - lw_dn - (1.0 - self.surface_albedo) * sw_dn
        return (net[1:] - net[:-1]) / g.dz_c_col

    def __call__(self, model, state, aux, G):
        """Heating in θ-units: −∇·ℐ / (cᵖᵐ Π) added to Gρθ
        (reference potential_temperature_tendency.jl:100-105)."""
        from ..thermo.constants import MoistureMassFractions
        from ..thermo.states import exner_function
        from .forcings import _rep

        c = model.constants
        div_I = self.flux_divergence(model, aux, state.time)
        q = aux.q if aux.q is not None else MoistureMassFractions(0.0, 0.0, 0.0)
        cpm = c.mixture_heat_capacity(q)
        Pi = exner_function(model.reference.p_col, q, c, model.p_standard)
        return _rep(G, rho_theta=G.rho_theta - div_I / (cpm * Pi))
