"""Hydrostatic reference states.

Equivalent of reference ``src/Thermodynamics/reference_states.jl``
(`ReferenceState` :18/:402, adiabatic closed forms :102-123, numerically
integrated Exner profiles :243-320, discrete balance :847-886).

Construction is *host-side* in float64 numpy — this is trace-time setup, run
once; profiles are then cast to the field dtype and stored as 1-D columns
broadcast into the compiled step.  (Matches the survey's precision plan:
selective f64 for reference-state integration.)
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..grid import Grid
from .constants import ThermodynamicConstants, MoistureMassFractions


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["p_c", "rho_c", "T_c", "rho_f", "qv_c", "ql_c", "qi_c"],
    meta_fields=["surface_pressure", "potential_temperature", "standard_pressure"],
)
@dataclasses.dataclass(frozen=True)
class ReferenceState:
    """Hydrostatic reference column for anelastic dynamics.

    Arrays are vertical profiles: centers ``(nz,)`` and faces ``(nz+1,)``.
    """

    surface_pressure: float
    potential_temperature: float     # value at the surface
    standard_pressure: float
    p_c: jax.Array
    rho_c: jax.Array
    T_c: jax.Array
    rho_f: jax.Array
    qv_c: jax.Array
    ql_c: jax.Array
    qi_c: jax.Array

    # Broadcastable columns
    @property
    def p_col(self):
        return self.p_c[:, None, None]

    @property
    def rho_col(self):
        return self.rho_c[:, None, None]

    @property
    def T_col(self):
        return self.T_c[:, None, None]

    @property
    def rho_f_col(self):
        """Face density at stored faces 0..nz-1."""
        return self.rho_f[:-1, None, None]

    def moisture_fractions_col(self) -> MoistureMassFractions:
        return MoistureMassFractions(
            self.qv_c[:, None, None], self.ql_c[:, None, None], self.qi_c[:, None, None])


# -- closed-form dry adiabatic profiles (reference :102-123) ---------------

def adiabatic_hydrostatic_pressure(z, p0, theta0, p_st, constants):
    cpd = constants.dry_air.heat_capacity
    Rd = constants.Rd
    g = constants.gravitational_acceleration
    T0 = theta0 * (p0 / p_st) ** (Rd / cpd)
    return p0 * (1.0 - g * z / (cpd * T0)) ** (cpd / Rd)


def adiabatic_hydrostatic_density(z, p0, theta0, p_st, constants):
    Rd = constants.Rd
    cpd = constants.dry_air.heat_capacity
    p = adiabatic_hydrostatic_pressure(z, p0, theta0, p_st, constants)
    T0 = theta0 * (p0 / p_st) ** (Rd / cpd)
    rho0 = p0 / (Rd * T0)
    return rho0 * (p / p0) ** (1.0 - Rd / cpd)


def _integrated_exner(z_points: np.ndarray, p0: float, theta_fn: Callable,
                      p_st: float, constants: ThermodynamicConstants,
                      n_sub: int = 64) -> np.ndarray:
    """Integrate dΠ/dz = -g/(cᵖᵈ θ(z)) from 0 to each z (midpoint rule).

    Mirrors reference ``numerically_integrated_hydrostatic_pressure``
    (:276-300): the dry hydrostatic balance is linear in the Exner function.
    """
    cpd = constants.dry_air.heat_capacity
    Rd = constants.Rd
    kappa = Rd / cpd
    g = constants.gravitational_acceleration
    Pi0 = (p0 / p_st) ** kappa

    out = np.empty_like(z_points)
    for idx, z in enumerate(z_points):
        if z == 0:
            out[idx] = Pi0
            continue
        zs = (np.arange(n_sub) + 0.5) * (z / n_sub)
        dPidz = -g / (cpd * np.asarray([theta_fn(zi) for zi in zs]))
        out[idx] = Pi0 + np.sum(dPidz) * (z / n_sub)
    return out


def make_reference_state(
    grid: Grid,
    constants: ThermodynamicConstants,
    surface_pressure: float = 101325.0,
    potential_temperature: float | Callable[[float], float] = 288.0,
    standard_pressure: float = 1.0e5,
    discrete_hydrostatic_balance: bool = False,
) -> ReferenceState:
    """Build a dry hydrostatic :class:`ReferenceState` on ``grid``.

    ``potential_temperature`` may be a constant (closed-form adiabatic
    profiles) or a function ``θ(z)`` (numerically integrated, reference
    :243-320).
    """
    p0 = float(surface_pressure)
    p_st = float(standard_pressure)
    Rd = constants.Rd
    cpd = constants.dry_air.heat_capacity
    kappa = Rd / cpd
    g = constants.gravitational_acceleration

    z_c = np.asarray(grid.z_c, np.float64)
    z_f = np.asarray(grid.z_f, np.float64)

    if callable(potential_temperature):
        theta_fn = potential_temperature
        theta0 = float(theta_fn(0.0))
        Pi_c = _integrated_exner(z_c, p0, theta_fn, p_st, constants)
        p_c = p_st * Pi_c ** (1.0 / kappa)
        theta_c = np.asarray([theta_fn(z) for z in z_c])
        T_c = theta_c * Pi_c
        rho_c = p_c / (Rd * T_c)
    else:
        theta0 = float(potential_temperature)
        p_c = adiabatic_hydrostatic_pressure(z_c, p0, theta0, p_st, constants)
        rho_c = adiabatic_hydrostatic_density(z_c, p0, theta0, p_st, constants)
        T_c = theta0 * (p_c / p_st) ** kappa

    # Surface density from the ideal gas law at (p0, T0).
    T0 = theta0 * (p0 / p_st) ** kappa
    rho0 = p0 / (Rd * T0)

    # Face densities: interior faces average adjacent centers; the bottom
    # face carries the surface density (reference's bottom ValueBC, :414-420);
    # the top face extends the last center (zero-gradient default).
    nz = grid.nz
    rho_f = np.empty(nz + 1, np.float64)
    rho_f[1:nz] = 0.5 * (rho_c[1:] + rho_c[:-1])
    rho_f[0] = rho0
    rho_f[nz] = rho_c[-1]

    if discrete_hydrostatic_balance:
        # Recompute p from rho so that (p[k] - p[k-1])/dz_f[k] = -g*rho_f[k]
        # holds exactly at interior faces (reference :847-886).
        dz_f = np.asarray(grid.dz_f, np.float64)
        p_c = p_c.copy()
        for k in range(1, nz):
            p_c[k] = p_c[k - 1] - g * rho_f[k] * dz_f[k]

    dt = grid.dtype
    zeros = jnp.zeros(nz, dt)
    return ReferenceState(
        surface_pressure=p0,
        potential_temperature=theta0,
        standard_pressure=p_st,
        p_c=jnp.asarray(p_c, dt),
        rho_c=jnp.asarray(rho_c, dt),
        T_c=jnp.asarray(T_c, dt),
        rho_f=jnp.asarray(rho_f, dt),
        qv_c=zeros, ql_c=zeros, qi_c=zeros,
    )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["p_c", "rho_c", "T_c", "theta_c", "exner_c", "rho_f", "qv_c"],
    meta_fields=["surface_pressure", "surface_potential_temperature", "standard_pressure"],
)
@dataclasses.dataclass(frozen=True)
class ExnerReferenceState:
    """Discretely-balanced reference state for split-explicit compressible
    dynamics.

    Equivalent of the reference's ``ExnerReferenceState``
    (``reference_states.jl:480-886``): built so the *discrete* face operator

        (p[k] − p[k−1]) / Δzᶠ[k] + g (ρ[k] + ρ[k−1]) / 2  =  0

    holds at every interior z-face to machine precision — the reference's
    key ingredient for rest-state stability of the acoustic substepper
    (docs compressible_dynamics.md "Reference state" section).
    """

    surface_pressure: float
    surface_potential_temperature: float
    standard_pressure: float
    p_c: jax.Array
    rho_c: jax.Array
    T_c: jax.Array
    theta_c: jax.Array
    exner_c: jax.Array
    rho_f: jax.Array
    qv_c: jax.Array

    @property
    def p_col(self):
        return self.p_c[:, None, None]

    @property
    def rho_col(self):
        return self.rho_c[:, None, None]

    @property
    def theta_col(self):
        return self.theta_c[:, None, None]

    @property
    def T_col(self):
        return self.T_c[:, None, None]

    @property
    def rho_f_col(self):
        return self.rho_f[:-1, None, None]


def make_exner_reference_state(
    grid: Grid,
    constants: ThermodynamicConstants,
    surface_pressure: float = 101325.0,
    potential_temperature: float | Callable[[float], float] = 300.0,
    vapor_mass_fraction: float | Callable[[float], float] | None = None,
    standard_pressure: float = 1.0e5,
    newton_iterations: int = 30,
) -> ExnerReferenceState:
    """Per-column Newton hydrostatic integration in discrete balance.

    Mirrors reference ``newton_hydrostatic_pressure`` /
    ``integrate_exner_column!`` (``reference_states.jl:588-700``): at each
    level solve the residual

        F(p) = (p − p[k−1])/Δzᶠ[k] + g (ρ(p) + ρ[k−1]) / 2,
        ρ(p) = p^{1−κ} (pˢᵗ)^κ / (Rᵐ θ̄ₖ)

    which is monotone in p; the first center is anchored by the continuous
    Exner recurrence over the half-step below it.
    """
    p0 = float(surface_pressure)
    p_st = float(standard_pressure)
    g = constants.gravitational_acceleration
    Rd, Rv = constants.Rd, constants.Rv
    cpd = constants.dry_air.heat_capacity
    cpv = constants.vapor.heat_capacity

    z_c = np.asarray(grid.z_c, np.float64)
    dz_f = np.asarray(grid.dz_f, np.float64)
    nz = grid.nz

    def theta_at(z):
        return (potential_temperature(z) if callable(potential_temperature)
                else float(potential_temperature))

    def qv_at(z):
        if vapor_mass_fraction is None:
            return 0.0
        return (vapor_mass_fraction(z) if callable(vapor_mass_fraction)
                else float(vapor_mass_fraction))

    theta_c = np.asarray([theta_at(z) for z in z_c])
    qv_c = np.asarray([qv_at(z) for z in z_c])
    Rm_c = (1.0 - qv_c) * Rd + qv_c * Rv
    cpm_c = (1.0 - qv_c) * cpd + qv_c * cpv
    kappa_c = Rm_c / cpm_c

    p_c = np.empty(nz, np.float64)
    rho_c = np.empty(nz, np.float64)

    # Anchor: continuous Exner recurrence over the half-step below center 0.
    kap0 = kappa_c[0]
    Pi_surf = (p0 / p_st) ** kap0
    Pi_0 = Pi_surf - g * (z_c[0] - float(grid.z0)) / (cpm_c[0] * theta_c[0])
    p_c[0] = p_st * Pi_0 ** (1.0 / kap0)
    rho_c[0] = p_c[0] ** (1.0 - kap0) * p_st ** kap0 / (Rm_c[0] * theta_c[0])

    for k in range(1, nz):
        kap = kappa_c[k]
        Rm_th = Rm_c[k] * theta_c[k]

        def rho_of(p):
            return p ** (1.0 - kap) * p_st ** kap / Rm_th

        # Continuous-Π initial guess
        Pi_prev = (p_c[k - 1] / p_st) ** kap
        Pi_guess = Pi_prev - g * dz_f[k] / (cpm_c[k] * theta_c[k])
        p = p_st * max(Pi_guess, 1e-10) ** (1.0 / kap)
        for _ in range(newton_iterations):
            F = (p - p_c[k - 1]) / dz_f[k] + g * 0.5 * (rho_of(p) + rho_c[k - 1])
            dF = 1.0 / dz_f[k] + g * 0.5 * (1.0 - kap) * rho_of(p) / p
            p_new = p - F / dF
            if abs(p_new - p) < 1e-13 * p:
                p = p_new
                break
            p = p_new
        p_c[k] = p
        rho_c[k] = rho_of(p)

    exner_c = (p_c / p_st) ** kappa_c
    T_c = theta_c * exner_c

    rho_f = np.empty(nz + 1, np.float64)
    rho_f[1:nz] = 0.5 * (rho_c[1:] + rho_c[:-1])
    rho_f[0] = rho_c[0]
    rho_f[nz] = rho_c[-1]

    dt = grid.dtype
    return ExnerReferenceState(
        surface_pressure=p0,
        surface_potential_temperature=float(theta_c[0]),
        standard_pressure=p_st,
        p_c=jnp.asarray(p_c, dt),
        rho_c=jnp.asarray(rho_c, dt),
        T_c=jnp.asarray(T_c, dt),
        theta_c=jnp.asarray(theta_c, dt),
        exner_c=jnp.asarray(exner_c, dt),
        rho_f=jnp.asarray(rho_f, dt),
        qv_c=jnp.asarray(qv_c, dt),
    )


def make_boussinesq_reference(grid: Grid, constants: ThermodynamicConstants,
                              surface_pressure: float = 101325.0,
                              potential_temperature: float = 288.0,
                              standard_pressure: float = 1.0e5) -> ReferenceState:
    """Constant-density (Boussinesq) reference state.

    Analogue of the reference's ``MoistAirBuoyancy`` use case
    (``src/MoistAirBuoyancies.jl:39-269``: Breeze moist thermodynamics inside
    a constant-density Oceananigans ``NonhydrostaticModel``, exercised by
    ``examples/boussinesq_bomex.jl``): ρᵣ = ρ₀ everywhere, hydrostatic
    pᵣ(z) = p₀ − ρ₀gz, Tᵣ from the moist-air EOS at (pᵣ, θ₀).  Plugging
    this reference into the anelastic model makes its projection the
    classical constant-coefficient Boussinesq pressure solve and its
    buoyancy the moist-air perturbation buoyancy.
    """
    from .states import temperature_from_theta_li
    from .constants import MoistureMassFractions

    p0 = float(surface_pressure)
    p_st = float(standard_pressure)
    theta0 = float(potential_temperature)
    Rd = constants.Rd
    cpd = constants.dry_air.heat_capacity
    kappa = Rd / cpd
    g_acc = constants.gravitational_acceleration

    T0 = theta0 * (p0 / p_st) ** kappa
    rho0 = p0 / (Rd * T0)

    z_c = np.asarray(grid.z_c, np.float64)
    p_c = p0 - rho0 * g_acc * z_c
    T_c = theta0 * (np.maximum(p_c, 1.0) / p_st) ** kappa
    nz = grid.nz

    dt = grid.dtype
    zeros = jnp.zeros(nz, dt)
    return ReferenceState(
        surface_pressure=p0,
        potential_temperature=theta0,
        standard_pressure=p_st,
        p_c=jnp.asarray(p_c, dt),
        rho_c=jnp.full(nz, rho0, dt),
        T_c=jnp.asarray(T_c, dt),
        rho_f=jnp.full(nz + 1, rho0, dt),
        qv_c=zeros, ql_c=zeros, qi_c=zeros,
    )


def reference_state_from_profiles(grid: Grid, constants: ThermodynamicConstants,
                                  T_profile, qv_profile=None,
                                  surface_pressure: float = 101325.0,
                                  standard_pressure: float = 1.0e5) -> ReferenceState:
    """Build a hydrostatic reference from given T(z) (+ qᵛ(z)) profiles.

    Mirrors reference ``compute_hydrostatic_reference!``
    (``reference_states.jl:165-240``): integrate d(ln p)/dz = −g/(RᵐT)
    upward with trapezoidal RᵐT averaging; ρ from the moist ideal gas law.
    This is the engine of ``set_to_mean!`` (``set_to_mean.jl:123``): pass
    horizontal-mean T and qᵛ to re-anchor the reference to the current state.
    """
    z_c = np.asarray(grid.z_c, np.float64)
    nz = grid.nz
    T = np.asarray(T_profile, np.float64) * np.ones(nz)
    qv = (np.zeros(nz) if qv_profile is None
          else np.asarray(qv_profile, np.float64) * np.ones(nz))
    Rd, Rv = constants.Rd, constants.Rv
    g = constants.gravitational_acceleration
    Rm = (1.0 - qv) * Rd + qv * Rv
    RmT = Rm * T

    p = np.empty(nz)
    # anchor the hydrostatic integration at the domain bottom (grid.z0, not
    # 0.0 — grids need not start at z = 0)
    z_prev, RmT_prev, p_prev = float(grid.z0), RmT[0], float(surface_pressure)
    for k in range(nz):
        dz = z_c[k] - z_prev
        p[k] = p_prev * np.exp(-g * dz / (0.5 * (RmT_prev + RmT[k])))
        z_prev, RmT_prev, p_prev = z_c[k], RmT[k], p[k]

    rho = p / RmT
    rho0 = surface_pressure / RmT[0]
    rho_f = np.empty(nz + 1)
    rho_f[1:nz] = 0.5 * (rho[1:] + rho[:-1])
    rho_f[0] = rho0
    rho_f[nz] = rho[-1]

    kappa = Rd / constants.dry_air.heat_capacity
    theta0 = float(T[0] * (standard_pressure / surface_pressure) ** kappa)

    dt = grid.dtype
    return ReferenceState(
        surface_pressure=float(surface_pressure),
        potential_temperature=theta0,
        standard_pressure=float(standard_pressure),
        p_c=jnp.asarray(p, dt), rho_c=jnp.asarray(rho, dt),
        T_c=jnp.asarray(T, dt), rho_f=jnp.asarray(rho_f, dt),
        qv_c=jnp.asarray(qv, dt),
        ql_c=jnp.zeros(nz, dt), qi_c=jnp.zeros(nz, dt),
    )


def set_to_mean(model, state):
    """Rebuild the model's reference state from the current horizontal means.

    Analogue of reference ``set_to_mean!`` (``set_to_mean.jl:123,165``):
    the reference column re-anchors to ⟨T⟩(z), ⟨qᵛ⟩(z) of the running state
    (a host-side, between-run operation — returns a NEW model; the state's
    density-weighted prognostics are rescaled to the new reference density,
    mirroring ``HydrostaticallyBalancedDensity`` :256).
    """
    import dataclasses as dc

    from ..dynamics.poisson import build_anelastic_poisson_solver
    from ..model import diagnose

    aux = diagnose(model, state)
    T_mean = np.asarray(jnp.mean(aux.T, axis=(1, 2)))
    qv_mean = (np.asarray(jnp.mean(aux.q.vapor, axis=(1, 2)))
               if model.has_moisture else None)
    new_ref = reference_state_from_profiles(
        model.grid, model.constants, T_mean, qv_mean,
        surface_pressure=model.reference.surface_pressure,
        standard_pressure=model.reference.standard_pressure)
    solver = build_anelastic_poisson_solver(model.grid, new_ref.rho_c,
                                            new_ref.rho_f)
    new_model = dc.replace(model, reference=new_ref, solver=solver)

    scale_c = new_ref.rho_col / model.reference.rho_col
    scale_f = new_ref.rho_f_col / model.reference.rho_f_col
    new_state = state.replace(
        rho_u=state.rho_u * scale_c, rho_v=state.rho_v * scale_c,
        rho_w=state.rho_w * scale_f,
        rho_theta=state.rho_theta * scale_c,
        rho_qt=None if state.rho_qt is None else state.rho_qt * scale_c,
        tracers={k: v * scale_c for k, v in state.tracers.items()},
    )
    return new_model, new_state


def with_moisture_profiles(ref: ReferenceState, qv=None, ql=None, qi=None) -> ReferenceState:
    """Return a copy of ``ref`` with moisture profiles replaced."""
    return dataclasses.replace(
        ref,
        qv_c=ref.qv_c if qv is None else jnp.asarray(qv, ref.qv_c.dtype),
        ql_c=ref.ql_c if ql is None else jnp.asarray(ql, ref.ql_c.dtype),
        qi_c=ref.qi_c if qi is None else jnp.asarray(qi, ref.qi_c.dtype),
    )
