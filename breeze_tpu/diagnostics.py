"""Diagnostic fields: potential temperature flavors, humidity, energy, means.

Equivalent of reference ``src/AtmosphereModels/Diagnostics/``
(potential temperatures ``potential_temperatures.jl:12-616``,
``SaturationSpecificHumidity`` :58, ``DewpointTemperature`` :81,
``StaticEnergy`` :72, ``azimuthal_mean`` :36-92) and
``src/Microphysics/microphysics_diagnostics.jl`` (`RelativeHumidity` :120).

The reference builds these as lazy ``KernelFunctionOperation``s; here each
is a pure function of (model, state/aux) — laziness is free under jit (dead
diagnostics are DCE'd; requested ones fuse).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .simulation import model_diagnose
from .thermo import saturation as sat
from .thermo import states
from .thermo.constants import MoistureMassFractions
from .thermo.solvers import newton_solve


def _pressure(model, aux):
    from .dynamics.compressible import CompressibleModel

    if isinstance(model, CompressibleModel):
        return aux.p
    return model.reference.p_col


def hydrostatic_pressure(model, state, aux=None):
    """Hydrostatic pressure diagnostic by upward integration of the
    instantaneous temperature field (reference
    ``compute_hydrostatic_pressure.jl:1-46``): per layer the cell-mean
    pressure of a locally isothermal hydrostatic column,

        p̄ₖ = p_bot (H/Δz)(1 − e^{−Δz/H}),  H = Rᵈ Tₖ/g,

    with the interface pressure advanced p_top = p_bot e^{−Δz/H}.
    Implemented as a ``lax.scan`` over z (the reference's per-column loop).
    """
    import jax

    aux = aux or model_diagnose(model, state)
    c = model.constants
    g = model.grid
    Rd = c.Rd
    g_acc = c.gravitational_acceleration
    p0 = getattr(model.reference, "surface_pressure", 101325.0)
    dz = jnp.asarray(g.dz_c)

    def layer(p_bot, inputs):
        T_k, dz_k = inputs
        H = Rd * T_k / g_acc
        decay = jnp.exp(-dz_k / H)
        p_mean = p_bot * (H / dz_k) * (1.0 - decay)
        return p_bot * decay, p_mean

    T = aux.T
    p_bot0 = jnp.full(g.shape[1:], p0, T.dtype)
    _, p_h = jax.lax.scan(layer, p_bot0, (T, dz))
    return p_h


def potential_temperature(model, state, aux=None):
    """Plain (dry) potential temperature θ = T/Πᵈ."""
    aux = aux or model_diagnose(model, state)
    c = model.constants
    p = _pressure(model, aux)
    kappa = c.Rd / c.dry_air.heat_capacity
    Pi_d = (p / model.p_standard) ** kappa
    return aux.T / Pi_d


def virtual_potential_temperature(model, state, aux=None):
    """θᵥ = θ Rᵐ/Rᵈ — the buoyancy-relevant flavor."""
    aux = aux or model_diagnose(model, state)
    c = model.constants
    q = getattr(aux, "q", None)
    if q is None:
        return potential_temperature(model, state, aux)
    Rm = c.mixture_gas_constant(q)
    return potential_temperature(model, state, aux) * Rm / c.Rd


def liquid_ice_potential_temperature(model, state, aux=None):
    aux = aux or model_diagnose(model, state)
    return aux.theta


def equivalent_potential_temperature(model, state, aux=None):
    """θₑ ≈ θ exp(ℒˡ qᵛ / (cᵖᵈ T)) (standard approximate form)."""
    aux = aux or model_diagnose(model, state)
    c = model.constants
    q = getattr(aux, "q", None)
    th = potential_temperature(model, state, aux)
    if q is None:
        return th
    L = c.liquid_latent_heat(aux.T)
    return th * jnp.exp(L * q.vapor / (c.dry_air.heat_capacity * aux.T))


def relative_humidity(model, state, aux=None):
    """ℋ = pᵛ/pᵛ⁺ (reference ``RelativeHumidity``)."""
    aux = aux or model_diagnose(model, state)
    c = model.constants
    q = getattr(aux, "q", None)
    if q is None:
        return jnp.zeros_like(aux.T)
    p = _pressure(model, aux)
    rho = c.density(aux.T, p, q)
    pv = c.vapor_pressure(aux.T, rho, q.vapor)
    pvs = sat.saturation_vapor_pressure(aux.T, c)
    return pv / pvs


def saturation_specific_humidity_field(model, state, aux=None):
    aux = aux or model_diagnose(model, state)
    c = model.constants
    p = _pressure(model, aux)
    q = getattr(aux, "q", None) or MoistureMassFractions(0.0, 0.0, 0.0)
    rho = c.density(aux.T, p, q)
    return sat.saturation_specific_humidity(aux.T, rho, c)


def dewpoint_temperature(model, state, aux=None, iterations: int = 5):
    """Td solving pᵛ⁺(Td) = pᵛ via fixed-count Newton (reference
    ``DewpointTemperature``, ``dewpoint_temperature.jl:81``)."""
    aux = aux or model_diagnose(model, state)
    c = model.constants
    q = getattr(aux, "q", None)
    if q is None:
        return aux.T
    p = _pressure(model, aux)
    rho = c.density(aux.T, p, q)
    pv = jnp.maximum(c.vapor_pressure(aux.T, rho, q.vapor), 1e-10)

    def residual(Td):
        return jnp.log(sat.saturation_vapor_pressure(Td, c)) - jnp.log(pv)

    return newton_solve(residual, aux.T, iterations=iterations)


def static_energy(model, state, aux=None):
    aux = aux or model_diagnose(model, state)
    q = getattr(aux, "q", None) or MoistureMassFractions(
        jnp.zeros_like(aux.T), jnp.zeros_like(aux.T), jnp.zeros_like(aux.T))
    z = model.grid.z_c_col
    return states.static_energy(aux.T, z, q, model.constants)


def total_energy(model, state, aux=None):
    """∫ρe + kinetic energy density (reference ``total_energy`` diag)."""
    aux = aux or model_diagnose(model, state)
    rho = getattr(state, "rho", None)
    if rho is None:
        rho = model.reference.rho_col
    ke = 0.5 * (aux.u ** 2 + aux.v ** 2 + aux.w ** 2)
    return rho * (static_energy(model, state, aux) + ke)


def horizontal_mean(field):
    """⟨·⟩(z): mean over (y, x)."""
    return jnp.mean(field, axis=(1, 2))


def azimuthal_mean(field, grid, x0: float, y0: float, n_bins: int | None = None):
    """Azimuthal average about (x0, y0) — for TC diagnostics (reference
    ``azimuthal_mean.jl:36-92``).  Returns (r_centers, mean(z, r))."""
    x = np.asarray(grid.x_c()) - x0
    y = np.asarray(grid.y_c()) - y0
    r = np.sqrt(x[None, :] ** 2 + y[:, None] ** 2)    # (ny, nx)
    n_bins = n_bins or grid.nx // 2
    r_max = min(grid.Lx, grid.Ly) / 2
    edges = np.linspace(0.0, r_max, n_bins + 1)
    idx = np.clip(np.digitize(r.ravel(), edges) - 1, 0, n_bins - 1)

    f = np.asarray(field).reshape(field.shape[0], -1)   # (nz, ny*nx)
    sums = np.zeros((field.shape[0], n_bins))
    counts = np.zeros(n_bins)
    np.add.at(counts, idx, 1.0)
    for k in range(field.shape[0]):
        np.add.at(sums[k], idx, f[k])
    means = sums / np.maximum(counts, 1.0)
    r_centers = 0.5 * (edges[1:] + edges[:-1])
    return r_centers, means


def number_concentration(model, state, species: str = "cloud"):
    """Droplet/raindrop number concentration [1/m³] from 2M prognostics.

    Reference ``number_concentration_field``
    (``microphysics_diagnostics.jl:254``); requires a two-moment scheme.
    """
    name = {"cloud": "rho_ncl", "rain": "rho_nr"}[species]
    if name not in state.tracers:
        raise ValueError(f"model has no prognostic {name} (needs a 2M scheme)")
    return state.tracers[name]   # ρ·(n/ρ) = n [1/m³]


def cfl_number(model, state, dt: float) -> float:
    from .simulation import cell_advection_timescale

    return dt / cell_advection_timescale(model, state)


def divergence_residual(model, state) -> float:
    """Residual of the anelastic constraint ∇·(ρu) = 0 after a projection.

    ``max|∇·(ρu)|`` over the largest single term of the divergence,
    ``max(|ρu|/Δx, |ρv|/Δy, |ρw|/Δz_min)``: the fraction of the terms that
    fail to cancel.  A projection that solved its Poisson problem to the
    working precision leaves a small multiple of that precision's unit
    roundoff (about 1e-7 in float32); a float32 matrix product taken in
    TF32 would leave about 1e-3.
    """
    from . import fields as fl
    g = model.grid
    so = model.stencil_ops()
    div = so.div_c(fl.pad(state.rho_u, g, fl.CCF),
                   fl.pad(state.rho_v, g, fl.CFC),
                   fl.pad(state.rho_w, g, fl.FCC))
    scale = max(float(jnp.abs(state.rho_u).max()) / g.dx,
                float(jnp.abs(state.rho_v).max()) / g.dy,
                float(jnp.abs(state.rho_w).max()) / g.dz_min)
    return float(jnp.abs(div).max()) / scale
