"""Spectral (multi-band) clear-sky and all-sky radiative transfer.

Counterpart of the reference's RRTMGP extension
(``ext/BreezeRRTMGPExt/clear_sky_radiative_transfer_model.jl:54-289``,
``all_sky_radiative_transfer_model.jl:76-330``) and the radiation interface
(``src/AtmosphereModels/radiation_interface.jl:215-255``: gas
``BackgroundAtmosphere`` incl. height-dependent ozone, surface radiative
properties, update scheduling).

Structural redesign, documented deviation from the reference: RRTMGP
is a data-driven correlated-k code (netCDF lookup tables, 16 g-points/band).
Here the same *capability surface* is provided by a self-contained
band model with published-form parameterizations:

- **LW** (8 bands): per-band gas optical depths (H₂O lines with pressure
  broadening, e-type water-vapor continuum in the window, CO₂ 15 µm,
  O₃ 9.6 µm, CH₄/N₂O 7.7 µm), Planck fractions by runtime Gauss-Legendre
  quadrature of the Planck function over each band, absorption-only
  two-stream with diffusivity factor 1.66, gray cloud mass absorption in
  the all-sky configuration.
- **SW** (4 bands): Rayleigh scattering, O₃ (Hartley/Huggins + Chappuis)
  and H₂O band absorption, δ-scaled hemispheric-mean two-stream layer
  reflectance/transmittance with an exactly energy-conserving direct-beam
  split, combined with the standard adding method (downward composite with
  from-below reflectance + upward composite, then interface fluxes).
- **All-sky**: liquid/ice cloud optics from the model condensate —
  τ = 3 LWP/(2 ρˡ rₑ), per-band single-scattering albedo and asymmetry.

Band absorption coefficients are tuned so broadband benchmarks land in
standard ranges (tropical clear sky: OLR ≈ 318 W/m² at Tₛ = 301 K, surface
downwelling LW ≈ 468, SW column absorption ≈ 80 W/m² overhead sun,
tropospheric LW cooling 1-3 K/day, 2×CO₂ OLR forcing ≈ 4.8 W/m²; thick
stratus albedo ≈ 0.77, cirrus greenhouse ≈ −29 W/m² OLR); every number is
pinned by ``tests/test_spectral_radiation.py``.

Scheduling: the model forcing reads a stored heating-rate diagnostic that a
:class:`RadiationUpdater` callback refreshes every N iterations (reference
``update_radiation!`` schedule semantics), or — the default — the fluxes
are recomputed inside the step like :class:`~.radiation.GrayRadiation`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .radiation import STEFAN_BOLTZMANN, FixedCosineZenith

# Physical constants
_H = 6.62607015e-34
_C = 2.99792458e8
_KB = 1.380649e-23
_M_AIR = 0.0289647      # kg/mol
_M_CO2 = 0.04401
_M_O3 = 0.048
_M_CH4 = 0.01604
_M_N2O = 0.04401


def standard_ozone_profile(z):
    """Idealized climatological O₃ volume mixing ratio vs height (reference
    ``standard_ozone_profile``, ``radiation_interface.jl:215-255``): weak
    tropospheric background blended into a Gaussian stratospheric layer
    peaking near 25 km."""
    tropo = 3e-8 * (1.0 + 0.5 * z / 1e3)
    strato = 8e-6 * jnp.exp(-(((z - 25e3) / 5e3) ** 2))
    chi = 1.0 / (1.0 + jnp.exp(-(z - 15e3) / 2.0))
    return tropo * (1.0 - chi) + strato * chi


@dataclasses.dataclass(frozen=True)
class BackgroundAtmosphere:
    """Well-mixed greenhouse-gas composition + spatially-varying O₃
    (reference ``BackgroundAtmosphere``; volume mixing ratios mol/mol).
    Halocarbon slots are carried for API parity; their radiative effect is
    folded into the CH₄/N₂O band in this band model (≲0.1 W/m²)."""

    co2: float = 420e-6
    ch4: float = 1.9e-6
    n2o: float = 0.33e-6
    o3: float | Callable = standard_ozone_profile
    cfc11: float = 0.0
    cfc12: float = 0.0
    cfc22: float = 0.0
    ccl4: float = 0.0


# ---------------------------------------------------------------------------
# LW band model
# ---------------------------------------------------------------------------

#: (ν_lo, ν_hi) [cm⁻¹], k_h2o, k_co2, k_o3, k_ch4n2o [m²/kg at p₀],
#: k_continuum [m²/kg per (e/1 kPa)]
#:
#: EXTERNALLY ANCHORED (tools/fit_lw_bands.py): the coefficients are fit
#: to published line-by-line broadband values for the AFGL tropical /
#: mid-latitude-summer / sub-arctic-winter clear-sky columns (OLR and
#: surface DLR; Clough & Iacono 1995, Mlawer et al. 1997, Iacono et al.
#: 2008 — see validation/radiation_columns.py) AND the published
#: instantaneous clear-sky 2×CO2 TOA forcing (~2.8 W/m² tropical).  The
#: 15 µm CO2 complex is split into a saturated core and two wing bands —
#: with a single gray coefficient the forcing comes out NEGATIVE (the
#: saturated core emits from the warm upper stratosphere); the wings carry
#: the physical sensitivity.  Fit residuals: all six fluxes within
#: 2.2 W/m² of the targets, forcing 2.81 W/m².
LW_BANDS = (
    # rotational H2O (far IR), split
    (10.0, 250.0, 32.15, 0.0, 0.0, 0.0, 0.0),
    (250.0, 410.0, 3.344, 0.0, 0.0, 0.0, 0.009993),
    (410.0, 560.0, 0.1048, 0.0, 0.0, 0.0, 0.01057),
    # CO2 15 um: lower wing / saturated core / upper wing
    (560.0, 630.0, 1.124, 4.761, 0.0, 0.0, 0.02),
    (630.0, 700.0, 1.0, 1111.0, 0.0, 0.0, 0.02),
    (700.0, 800.0, 0.4707, 1.551, 0.0, 0.0, 0.02011),
    # window + continuum
    (800.0, 980.0, 0.0113, 0.0, 0.0, 0.0, 0.002098),
    # O3 9.6 um
    (980.0, 1100.0, 0.0113, 0.0, 13.87, 0.0, 0.002257),
    # CH4 + N2O 7.7 um
    (1100.0, 1400.0, 0.02289, 0.0, 0.0, 2.414, 0.002636),
    # H2O 6.3 um vibration-rotation
    (1400.0, 2200.0, 6.072, 0.0, 0.0, 0.0, 0.0),
    (2200.0, 3500.0, 5.385, 0.4185, 0.0, 0.0, 0.0),
)

_GL_X, _GL_W = np.polynomial.legendre.leggauss(8)


def planck_band_fraction(T, nu_lo, nu_hi):
    """Fraction of σT⁴ emitted in [ν_lo, ν_hi] (cm⁻¹) by 8-point
    Gauss-Legendre quadrature of the Planck function."""
    nu1 = nu_lo * 100.0      # 1/m
    nu2 = nu_hi * 100.0
    half = 0.5 * (nu2 - nu1)
    mid = 0.5 * (nu2 + nu1)
    total = jnp.zeros_like(T)
    c2 = _H * _C / _KB
    for xi, wi in zip(_GL_X, _GL_W):
        nu = mid + half * float(xi)
        # spectral radiance ∝ ν³/(exp(c₂ν/T) − 1)
        x = c2 * nu / T
        total = total + float(wi) * nu ** 3 / jnp.expm1(jnp.minimum(x, 80.0))
    total = total * half * (2.0 * math.pi * _H * _C ** 2)
    return total / (STEFAN_BOLTZMANN * T ** 4)


# ---------------------------------------------------------------------------
# SW band model
# ---------------------------------------------------------------------------

#: (solar fraction, k_h2o [m²/kg at p₀], k_o3 [m²/kg], τ_rayleigh per
#:  (Δp/p₀₀) with p₀₀ = 1013.25 hPa)
#:
#: EXTERNALLY ANCHORED (round 4): the water-vapor side is the PUBLISHED
#: Lacis & Hansen (1974, JAS 31, table 1) k-distribution — 8 exponential-
#: sum terms (weight pₙ, absorption kₙ per cm of pressure-scaled
#: precipitable water = kₙ/10 m²/kg) whose sum Σpₙ(1−e^{−kₙy}) reproduces
#: their LBL-fit absorption function A_wv(y) = 2.9y/((1+141.5y)^0.635 +
#: 5.925y).  Term 0 carries the visible/UV region (negligible vapor
#: absorption) with ozone + the full Rayleigh scattering, exactly the LH74
#: composite (scattering confined to λ < 0.9 µm).  The clear-sky columns
#: are validated against an independent LH74 implementation in
#: ``validation/radiation_columns.py`` (±15 W/m² tolerance; fitted via
#: ``tools/fit_sw_bands.py``, residuals ≤3.5 W/m² over {tropical, MLS,
#: SAW} × {(μ₀=1, α=0.06), (μ₀=0.5, α=0.2)} on TOA-up, surface-down and
#: column absorption).  Ozone splits into a saturated Hartley/Huggins UV
#: term and a linear Chappuis term — one gray coefficient cannot match
#: both sun angles (the UV band is in the strong-line square-root regime).
#: The reference instead carries the full RRTMGP SW tables
#: (``ext/BreezeRRTMGPExt/clear_sky_radiative_transfer_model.jl:54-289``).
SW_BANDS = (
    # saturated Hartley/Huggins UV ozone (strong-line limit: the band is
    # opaque for any realistic column, carrying LH74's flat A_uv(x))
    (0.015, 0.0, 600.0, 0.0),
    # visible: linear-regime Chappuis ozone + ALL the Rayleigh scattering
    (0.632, 4.0e-6, 1.6, 0.155),
    # LH74 table-1 water-vapor k-distribution terms (near IR)
    (0.0698, 2.0e-4, 0.0, 0.0),
    (0.1443, 3.5e-3, 0.0, 0.0),
    (0.0584, 3.77e-2, 0.0, 0.0),
    (0.0335, 1.95e-1, 0.0, 0.0),
    (0.0225, 9.40e-1, 0.0, 0.0),
    (0.0158, 4.46, 0.0, 0.0),
    (0.0087, 19.0, 0.0, 0.0),
)

#: per-SW-band liquid/ice cloud single-scattering albedo and asymmetry
#: (UV/visible terms conservative; deeper near-IR terms increasingly
#: absorbing, Slingo-style ordering by vapor-k as a wavelength proxy)
SW_CLOUD_SSA_LIQ = (0.999999, 0.999999, 0.9995, 0.9990, 0.997, 0.991,
                    0.975, 0.93, 0.88)
SW_CLOUD_SSA_ICE = (0.999995, 0.999995, 0.998, 0.996, 0.990, 0.975,
                    0.950, 0.89, 0.84)
SW_CLOUD_G_LIQ = 0.85
SW_CLOUD_G_ICE = 0.80
LW_CLOUD_K_LIQ = 140.0     # gray mass absorption [m²/kg]
LW_CLOUD_K_ICE = 70.0


@dataclasses.dataclass(frozen=True)
class SurfaceRadiativeProperties:
    """Reference ``SurfaceRadiativeProperties``: emissivity + direct /
    diffuse albedos (scalar)."""

    emissivity: float = 0.98
    direct_albedo: float = 0.06
    diffuse_albedo: float = 0.06


@dataclasses.dataclass(frozen=True)
class SpectralRadiation:
    """Clear-sky (``optics="clear"``) or all-sky (``optics="all"``)
    multi-band radiative transfer as a θ-tendency forcing, interface-
    compatible with :class:`~.radiation.GrayRadiation`.

    ``effective_radius_liquid/ice``: cloud optics sizes [m]; with a
    two-moment scheme the liquid size is diagnosed from the droplet
    number instead.
    """

    optics: str = "clear"                  # "clear" | "all"
    background: BackgroundAtmosphere = dataclasses.field(
        default_factory=BackgroundAtmosphere)
    surface: SurfaceRadiativeProperties = dataclasses.field(
        default_factory=SurfaceRadiativeProperties)
    solar_constant: float = 1361.0
    surface_temperature: float | None = None
    solar_position: object = dataclasses.field(default_factory=FixedCosineZenith)
    effective_radius_liquid: float = 10e-6
    effective_radius_ice: float = 30e-6
    pressure_broadening_exponent: float = 0.75
    #: when set, ``__call__`` reads the stored heating diagnostic (filled by
    #: :class:`RadiationUpdater`) instead of recomputing every step.
    use_stored_heating: bool = False

    # -- gas layer masses ----------------------------------------------
    def _layer_paths(self, model, aux):
        g = model.grid
        ref = model.reference
        bg = self.background
        rho = jnp.broadcast_to(ref.rho_col, g.shape)
        dz = g.dz_c_col
        # water vapor path per layer [kg/m²]
        qv = (aux.q.vapor if aux.q is not None else jnp.zeros(g.shape, g.dtype))
        u_h2o = rho * qv * dz
        dm_air = rho * dz                       # air mass path
        u_co2 = bg.co2 * (_M_CO2 / _M_AIR) * dm_air
        u_ch4n2o = (bg.ch4 * (_M_CH4 / _M_AIR)
                    + 2.0 * bg.n2o * (_M_N2O / _M_AIR)) * dm_air
        o3 = bg.o3
        z_col = jnp.asarray(g.z_c)[:, None, None]
        o3_vmr = (o3(z_col) if callable(o3)
                  else jnp.full((g.nz, 1, 1), o3, g.dtype))
        u_o3 = o3_vmr * (_M_O3 / _M_AIR) * dm_air
        # pressure-broadening weight and vapor pressure [kPa]
        p = jnp.broadcast_to(ref.p_col, g.shape)
        pw = (p / 1.0e5) ** self.pressure_broadening_exponent
        e_kpa = rho * qv * (model.constants.Rv) * aux.T / 1000.0
        return u_h2o, u_co2, u_o3, u_ch4n2o, pw, e_kpa

    def _cloud_paths(self, model, aux):
        """(LWP, IWP) per layer [kg/m²] (zero for clear-sky optics)."""
        g = model.grid
        if self.optics != "all" or aux.q is None:
            zero = jnp.zeros(g.shape, g.dtype)
            return zero, zero
        rho = jnp.broadcast_to(model.reference.rho_col, g.shape)
        dz = g.dz_c_col
        return rho * aux.q.liquid * dz, rho * aux.q.ice * dz

    # -- LW ------------------------------------------------------------
    def lw_fluxes(self, model, aux):
        """(lw_up, lw_dn) at z-faces 0..nz."""
        g = model.grid
        nz = g.nz
        u_h2o, u_co2, u_o3, u_ch4n2o, pw, e_kpa = self._layer_paths(model, aux)
        lwp, iwp = self._cloud_paths(model, aux)
        T = aux.T
        Ts = (self.surface_temperature if self.surface_temperature is not None
              else T[0])
        Ts = jnp.broadcast_to(jnp.asarray(Ts, g.dtype), g.shape[1:])
        eps_s = self.surface.emissivity
        D = 1.66  # diffusivity factor

        lw_up = jnp.zeros((nz + 1,) + g.shape[1:], g.dtype)
        lw_dn = jnp.zeros((nz + 1,) + g.shape[1:], g.dtype)
        sigT4 = STEFAN_BOLTZMANN * T ** 4
        sigTs4 = STEFAN_BOLTZMANN * Ts ** 4
        tau_cloud = LW_CLOUD_K_LIQ * lwp + LW_CLOUD_K_ICE * iwp

        for (nu1, nu2, kh, kc, ko, km, kcont) in LW_BANDS:
            tau = (kh * u_h2o * pw + kc * u_co2 * pw + ko * u_o3 * pw
                   + km * u_ch4n2o * pw + kcont * u_h2o * e_kpa
                   + tau_cloud)
            trans = jnp.exp(-D * tau).astype(g.dtype)
            fB = planck_band_fraction(T, nu1, nu2)
            B = (fB * sigT4).astype(g.dtype)

            def up_scan(F, inputs):
                t_k, B_k = inputs
                F_new = F * t_k + B_k * (1.0 - t_k)
                return F_new, F_new

            F0 = (eps_s * planck_band_fraction(Ts, nu1, nu2)
                  * sigTs4).astype(g.dtype)
            _, up_faces = jax.lax.scan(up_scan, F0, (trans, B))
            lw_up = lw_up + jnp.concatenate([F0[None], up_faces], axis=0)

            Ftop = jnp.zeros(g.shape[1:], g.dtype)
            _, dn_faces = jax.lax.scan(up_scan, Ftop, (trans[::-1], B[::-1]))
            lw_dn = lw_dn + jnp.concatenate([Ftop[None], dn_faces],
                                            axis=0)[::-1]
        return lw_up, lw_dn

    # -- SW ------------------------------------------------------------
    def band_optics(self, model, aux):
        """Per-band layer optical properties: list of
        ``(frac, tau, omega, g_asym)`` with (nz, ny, nx) layer arrays —
        the SINGLE source consumed by :meth:`sw_fluxes` AND the
        independent Monte-Carlo anchor (``validation/sw_monte_carlo.py``,
        ``tests/test_spectral_radiation.py``), so the MC checks exactly
        the optics the solver sees."""
        g = model.grid
        u_h2o, u_co2, u_o3, u_ch4n2o, _, _ = self._layer_paths(model, aux)
        # LH74 water-vapor path scaling (their eq. 21): (p/p₀)·(273/T)^½ —
        # the k-distribution terms in SW_BANDS are calibrated to it
        p = jnp.broadcast_to(model.reference.p_col, g.shape)
        pw = ((p / 1.0e5) * jnp.sqrt(273.0 / aux.T)).astype(g.dtype)
        lwp, iwp = self._cloud_paths(model, aux)
        ref = model.reference
        dp = -jnp.gradient(jnp.asarray(ref.p_c))  # (nz,) > 0

        rel = self.effective_radius_liquid
        rei = self.effective_radius_ice
        tau_cl = 1.5 * lwp / (1000.0 * rel)
        tau_ci = 1.5 * iwp / (916.7 * rei)

        out = []
        for b, (frac, kh, ko, tray) in enumerate(SW_BANDS):
            tau_gas = kh * u_h2o * pw + ko * u_o3
            tau_r = jnp.broadcast_to(
                (tray * dp / 101325.0)[:, None, None], g.shape)
            tau_c = tau_cl + tau_ci
            tau = (tau_gas + tau_r + tau_c).astype(g.dtype)
            # single-scattering albedo and asymmetry (Rayleigh ω=1, g=0)
            w_c = SW_CLOUD_SSA_LIQ[b] * tau_cl + SW_CLOUD_SSA_ICE[b] * tau_ci
            omega = jnp.clip((tau_r + w_c)
                             / jnp.maximum(tau, 1e-12),
                             0.0, 1.0 - 1e-6).astype(g.dtype)
            g_asym = ((SW_CLOUD_G_LIQ * SW_CLOUD_SSA_LIQ[b] * tau_cl
                       + SW_CLOUD_G_ICE * SW_CLOUD_SSA_ICE[b] * tau_ci)
                      / jnp.maximum(tau_r + w_c, 1e-12)).astype(g.dtype)
            out.append((frac, tau, omega, g_asym))
        return out

    def sw_fluxes(self, model, aux, time):
        """(sw_dn, sw_up) at z-faces 0..nz (direct+diffuse combined)."""
        g = model.grid
        nz = g.nz
        mu0 = jnp.maximum(jnp.asarray(self.solar_position(time), g.dtype),
                          0.0)
        daylight = mu0 > 1e-4
        mu = jnp.maximum(mu0, 1e-4)

        sw_dn = jnp.zeros((nz + 1,) + g.shape[1:], g.dtype)
        sw_up = jnp.zeros((nz + 1,) + g.shape[1:], g.dtype)

        for frac, tau, omega, g_asym in self.band_optics(model, aux):
            F0 = self.solar_constant * frac * mu
            dn_b, up_b = _two_stream_adding(
                tau, omega, g_asym, mu,
                self.surface.direct_albedo, self.surface.diffuse_albedo, F0)
            sw_dn = sw_dn + dn_b
            sw_up = sw_up + up_b

        zero = jnp.zeros_like(sw_dn)
        return (jnp.where(daylight, sw_dn, zero),
                jnp.where(daylight, sw_up, zero))

    # -- forcing interface ---------------------------------------------
    def fluxes(self, model, aux, time):
        lw_up, lw_dn = self.lw_fluxes(model, aux)
        sw_dn, sw_up = self.sw_fluxes(model, aux, time)
        return lw_up, lw_dn, sw_dn, sw_up

    def flux_divergence(self, model, aux, time):
        """∇·ℐ at cell centers [W/m³] (net upward convention)."""
        g = model.grid
        lw_up, lw_dn, sw_dn, sw_up = self.fluxes(model, aux, time)
        net = lw_up - lw_dn + sw_up - sw_dn
        return (net[1:] - net[:-1]) / g.dz_c_col

    def heating_rate(self, model, aux, time):
        """Radiative θ-tendency [K(θ)/s] at centers."""
        from ..thermo.constants import MoistureMassFractions
        from ..thermo.states import exner_function

        c = model.constants
        div_I = self.flux_divergence(model, aux, time)
        q = aux.q if aux.q is not None else MoistureMassFractions(0.0, 0.0, 0.0)
        cpm = c.mixture_heat_capacity(q)
        Pi = exner_function(model.reference.p_col, q, c, model.p_standard)
        return -div_I / (cpm * Pi)

    def __call__(self, model, state, aux, G):
        from .forcings import _rep

        if self.use_stored_heating:
            heat = state.diagnostics.get("radiative_heating")
            if heat is None:
                heat = self.heating_rate(model, aux, state.time)
        else:
            heat = self.heating_rate(model, aux, state.time)
        return _rep(G, rho_theta=G.rho_theta + heat)


def _two_stream_adding(tau, omega, g_asym, mu0, alb_dir, alb_dif, F0):
    """δ-scaled hemispheric-mean two-stream + adding method.

    ``tau/omega/g_asym``: (nz, ny, nx) layer properties (z increasing
    upward).  Returns total (down, up) fluxes at faces 0..nz for incident
    direct flux ``F0 = S μ0`` at TOA.

    Layer solution: hemispheric-mean γ₁ = 2 − ω(1+g), γ₂ = ω(1−g) for the
    diffuse reflectance/transmittance; the direct beam is attenuated at
    exp(−τ/μ₀) with its scattered fraction injected at the layer
    boundaries split by the Eddington direct backscatter fraction
    γ₃ = (2−3gμ₀)/4 — exactly energy-conserving (R+T+A ≡ 1).

    Adding sweeps (per Stephens 1984 composite formulas): a downward scan
    accumulates the above-composite (direct transmission T0ᶜ, total direct
    transmittance Tᵈⁱʳ, from-below diffuse reflectance R^fb) and an upward
    scan the below-composite (Rᵈⁱʳ, Rᵈⁱᶠ incl. surface); interface fluxes
    follow from the standard multiple-reflection closure.
    """
    # δ-scaling
    f = g_asym * g_asym
    tau_p = (1.0 - omega * f) * tau
    omega_p = jnp.clip((1.0 - f) * omega / (1.0 - omega * f),
                       0.0, 1.0 - 1e-6)
    g_p = g_asym / (1.0 + g_asym)

    gamma1 = 2.0 - omega_p * (1.0 + g_p)
    gamma2 = omega_p * (1.0 - g_p)
    gamma3 = jnp.clip((2.0 - 3.0 * g_p * mu0) / 4.0, 0.0, 1.0)

    def layer_props_co(tau_l):
        """Hemispheric-mean diffuse + single-scatter direct split for a
        THIN sublayer, in co-transmittance form (E = 1 − T) so that f32
        keeps the O(τ) absorptance exactly (``expm1``-based; a plain
        ``1 − exp(−τ)`` rounds to ZERO at the doubling init τ ~ 1e-8 and
        silently deleted all thin-layer — i.e. clear-sky ozone —
        absorption, while rounding noise in 1−T manufactured ~1% spurious
        absorption in conservative Rayleigh layers)."""
        lam = jnp.sqrt(jnp.maximum(gamma1 ** 2 - gamma2 ** 2, 1e-12))
        Gam = gamma2 / (gamma1 + lam)
        one_m_e = -jnp.expm1(-jnp.minimum(lam * tau_l, 60.0))   # 1 − e
        e = 1.0 - one_m_e
        den = 1.0 - (Gam * e) ** 2
        Rdif = Gam * one_m_e * (1.0 + e) / den
        #  1 − Tdif = (1−e)(1 + Γ²e)/den   (exact algebra, no cancellation)
        Edif = one_m_e * (1.0 + Gam * Gam * e) / den
        E0 = -jnp.expm1(-jnp.minimum(tau_l / mu0, 60.0))        # 1 − T0
        Rdir = omega_p * E0 * gamma3
        #  1 − Tdir = E0·(1 − ω(1−γ₃))
        Edir = E0 * (1.0 - omega_p * (1.0 - gamma3))
        return Rdif, Edif, Rdir, Edir, E0

    # Doubling: initialize at τ/2ⁿ (where the single-scatter direct split is
    # accurate) and double n times with the direct+diffuse adding formulas —
    # recovers the correct thick-layer limit (e.g. a τ=80 conservative cloud
    # reflects ~0.85 of the beam instead of forward-leaking it).  The
    # recurrence runs on (R, E=1−T): every update combines SMALL quantities
    # multiplicatively/additively, so the layer absorptance survives f32.
    N_DOUBLINGS = 14
    Rdif, Edif, Rdir, Edir, E0 = layer_props_co(tau_p / (2 ** N_DOUBLINGS))
    for _ in range(N_DOUBLINGS):
        den = 1.0 - Rdif * Rdif
        Tdif = 1.0 - Edif
        # Tdir − T0 = E0 − Edir (difference of the two small co-terms)
        dTd = E0 - Edir
        Rdir_n = Rdir + Tdif * ((1.0 - E0) * Rdir + dTd * Rdif) / den
        # Edir' = 1 − T0·Tdir − Tdif(dTd + T0·Rdir·Rdif)/den, expanded so
        # no 1−x cancellation appears:
        Edir_n = (E0 + Edir - E0 * Edir
                  - Tdif * (dTd + (1.0 - E0) * Rdir * Rdif) / den)
        Rdif_n = Rdif + Tdif * Tdif * Rdif / den
        # Edif' = 1 − Tdif²/den = (2Edif − Edif² − Rdif²)/den
        Edif_n = (2.0 * Edif - Edif * Edif - Rdif * Rdif) / den
        E0 = 2.0 * E0 - E0 * E0               # 1 − T0²
        Rdif, Edif, Rdir, Edir = Rdif_n, Edif_n, Rdir_n, Edir_n
    Tdif = 1.0 - Edif
    Tdir = 1.0 - Edir
    T0 = 1.0 - E0

    # order layers top -> bottom for the sweeps
    flip = lambda a: a[::-1]
    Rdif_t, Tdif_t = flip(Rdif), flip(Tdif)
    Rdir_t, Tdir_t, T0_t = flip(Rdir), flip(Tdir), flip(T0)

    # Downward sweep: composite of everything ABOVE each interface.
    # State: (T0c, Tdirc, Rfb) — direct transmission, total transmittance
    # for direct incidence, from-below diffuse reflectance.
    shp = tau.shape[1:]
    dt_ = tau.dtype

    def down(carry, layer):
        T0c, Tdirc, Rfb = carry
        Rd_l, Td_l, Rr_l, Tr_l, T0_l = layer
        den = 1.0 - Rfb * Rd_l
        Tdirc_new = (T0c * Tr_l
                     + Td_l * ((Tdirc - T0c) + T0c * Rr_l * Rfb) / den)
        Rfb_new = Rd_l + Td_l * Td_l * Rfb / den
        T0c_new = T0c * T0_l
        new = (T0c_new, Tdirc_new, Rfb_new)
        return new, new

    init_above = (jnp.ones(shp, dt_), jnp.ones(shp, dt_), jnp.zeros(shp, dt_))
    _, above = jax.lax.scan(
        down, init_above, (Rdif_t, Tdif_t, Rdir_t, Tdir_t, T0_t))
    # above[k] = composite of layers 0..k (top->bottom); interface i (below
    # layer i-1) uses above[i-1]; interface 0 (TOA) uses the identity.
    T0c = jnp.concatenate([init_above[0][None], above[0]], axis=0)
    Tdirc = jnp.concatenate([init_above[1][None], above[1]], axis=0)
    Rfb = jnp.concatenate([init_above[2][None], above[2]], axis=0)

    # Upward sweep: composite of everything BELOW each interface
    # (incl. surface).  State: (Rdir_b, Rdif_b).
    def up(carry, layer):
        Rdir_b, Rdif_b = carry
        Rd_l, Td_l, Rr_l, Tr_l, T0_l = layer
        den = 1.0 - Rd_l * Rdif_b
        Rdir_new = (Rr_l + Td_l * (T0_l * Rdir_b
                                   + (Tr_l - T0_l) * Rdif_b) / den)
        Rdif_new = Rd_l + Td_l * Td_l * Rdif_b / den
        new = (Rdir_new, Rdif_new)
        return new, new

    init_below = (jnp.full(shp, alb_dir, dt_), jnp.full(shp, alb_dif, dt_))
    _, below = jax.lax.scan(
        up, init_below,
        (flip(Rdif_t), flip(Tdif_t), flip(Rdir_t), flip(Tdir_t), flip(T0_t)))
    # below scanned bottom-up over top->bottom-flipped arrays = original
    # z-up order; below[k] = composite of layers surface..k. Interface i in
    # top->bottom numbering (i = 0 TOA … nz surface): below-system =
    # layers i..nz-1 (top->bottom) = below[nz-1-i] for i<nz, surface for i=nz.
    Rdir_b_all = jnp.concatenate([below[0][::-1], init_below[0][None]], axis=0)
    Rdif_b_all = jnp.concatenate([below[1][::-1], init_below[1][None]], axis=0)

    # Interface fluxes (top->bottom indexing)
    den = 1.0 - Rfb * Rdif_b_all
    Fdn_dir = F0 * T0c
    Fdn_dif = F0 * ((Tdirc - T0c) + T0c * Rdir_b_all * Rfb) / den
    Fup = F0 * (T0c * Rdir_b_all + (Tdirc - T0c) * Rdif_b_all) / den

    # back to z-up face order (face 0 = surface, face nz = TOA)
    dn = (Fdn_dir + Fdn_dif)[::-1]
    up_f = Fup[::-1]
    return dn, up_f


@dataclasses.dataclass
class RadiationUpdater:
    """Simulation callback refreshing ``state.diagnostics['radiative_heating']``
    on a schedule (reference ``update_radiation!`` + ``IterationInterval``);
    pair with ``SpectralRadiation(use_stored_heating=True)``."""

    radiation: SpectralRadiation
    interval: int = 1      # iterations between updates

    def __call__(self, sim):
        if sim.iteration % max(self.interval, 1) != 0 and \
                "radiative_heating" in sim.state.diagnostics:
            return
        from ..simulation import model_diagnose
        aux = model_diagnose(sim.model, sim.state)
        heat = self.radiation.heating_rate(sim.model, aux, sim.state.time)
        sim.state = sim.state.replace(
            diagnostics={**sim.state.diagnostics, "radiative_heating": heat})
