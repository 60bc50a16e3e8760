"""The AtmosphereModel hub: state, configuration, diagnostics, tendencies.

Re-design of the reference's ``src/AtmosphereModels/`` layer
(`AtmosphereModel` struct ``atmosphere_model.jl:37-313``, tendency kernels
``dynamics_kernel_functions.jl``, state refresh
``update_atmosphere_model_state.jl:41-68``).  The reference's
multiple-dispatch lattice (dynamics × formulation × microphysics × closure)
becomes typed configs selecting pure functions; mutable ``Field`` storage
becomes an immutable ``State`` pytree; ``update_state!`` becomes
:func:`diagnose`, a pure function recomputed (and fused by XLA) inside each
RK stage.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from . import advection as adv
from . import fields as fl
from .dynamics.poisson import AnelasticPoissonSolver, build_anelastic_poisson_solver
from .grid import Grid
from .ops import StencilOps
from .physics.coriolis import coriolis_terms
from .physics.microphysics import SaturationAdjustment, saturation_adjust
from .thermo.constants import MoistureMassFractions, ThermodynamicConstants
from .thermo.reference import ReferenceState, make_reference_state
from .thermo.states import temperature_from_theta_li, theta_li_from_temperature


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

@partial(
    jax.tree_util.register_dataclass,
    data_fields=["rho_u", "rho_v", "rho_w", "rho_theta", "rho_qt", "tracers",
                 "time", "diagnostics"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class State:
    """Prognostic state: momentum + thermodynamic density (+ moisture, tracers).

    Mirrors the reference's prognostic set for anelastic dynamics
    (``atmosphere_model.jl:379-386``): ρu, ρv, ρw on staggered faces, ρθ,
    optionally ρqᵗ and user tracers.  ``time`` is a traced scalar.

    ``diagnostics`` carries non-advected stepwise outputs (e.g. Kessler's
    surface precipitation, reference ``dcmip2016_kessler.jl:355-394``);
    keys are seeded at :func:`initial_state` so the pytree structure is
    stable under ``lax.fori_loop``.
    """

    rho_u: jax.Array
    rho_v: jax.Array
    rho_w: jax.Array
    rho_theta: jax.Array
    rho_qt: jax.Array | None
    tracers: dict[str, jax.Array]
    time: jax.Array
    diagnostics: dict[str, jax.Array] = dataclasses.field(default_factory=dict)

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


class Aux(NamedTuple):
    """Diagnostics refreshed from the prognostic state every stage.

    The reference stores these in mutable fields (velocities, temperature,
    microphysical fractions — ``update_atmosphere_model_state.jl:256-292``);
    here they are recomputed functionally and fused into consumers.
    """

    u: jax.Array
    v: jax.Array
    w: jax.Array
    theta: jax.Array
    qt: jax.Array | None
    T: jax.Array
    q: MoistureMassFractions
    buoyancy_force: jax.Array  # at cell centers, −g ρ′


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

@partial(
    jax.tree_util.register_dataclass,
    data_fields=["grid", "reference", "solver", "forcing_data", "immersed"],
    meta_fields=[
        "constants", "momentum_advection", "scalar_advection",
        "microphysics", "coriolis", "closure", "forcings",
        "boundary_fluxes", "p_standard", "formulation",
    ],
)
@dataclasses.dataclass(frozen=True)
class AtmosphereModel:
    """Anelastic atmosphere model configuration.

    Analogue of ``AtmosphereModel(grid; dynamics, advection,
    microphysics, closure, ...)`` (reference ``atmosphere_model.jl:114-313``)
    specialized to ``AnelasticDynamics`` + liquid-ice potential temperature
    formulation (the reference's defaults).
    """

    grid: Grid
    reference: ReferenceState
    solver: AnelasticPoissonSolver
    forcing_data: Any              # pytree consumed by `forcings` entries
    constants: ThermodynamicConstants
    momentum_advection: Any
    scalar_advection: Any
    microphysics: Any              # None | SaturationAdjustment
    coriolis: Any                  # None | FPlane | ...
    closure: Any                   # None | SmagorinskyLilly (physics.closures)
    forcings: tuple                # tuple of callables (model, state, aux) -> G-increments
    boundary_fluxes: Any           # None | physics.surface.BoundaryFluxes
    p_standard: float
    formulation: str = "theta_li"  # "theta_li" (ρθˡⁱ) | "static_energy" (ρe)
    immersed: Any = None           # None | dynamics.immersed.GridFittedBottom

    @property
    def has_moisture(self) -> bool:
        return self.microphysics is not None

    def stencil_ops(self) -> StencilOps:
        return StencilOps(self.grid)


def make_model(
    grid: Grid,
    constants: ThermodynamicConstants | None = None,
    reference: ReferenceState | None = None,
    momentum_advection=None,
    scalar_advection=None,
    advection=None,
    microphysics=None,
    coriolis=None,
    closure=None,
    forcings=(),
    forcing_data=None,
    boundary_fluxes=None,
    immersed=None,
    surface_pressure: float = 101325.0,
    potential_temperature=288.0,
    p_standard: float = 1.0e5,
    formulation: str = "theta_li",
) -> AtmosphereModel:
    """Model factory (host-side; allocates reference profiles + solver)."""
    constants = constants or ThermodynamicConstants()
    if reference is None:
        reference = make_reference_state(
            grid, constants,
            surface_pressure=surface_pressure,
            potential_temperature=potential_temperature)
    if advection is not None:
        momentum_advection = momentum_advection or advection
        scalar_advection = scalar_advection or advection
    momentum_advection = momentum_advection or adv.Centered(2)
    scalar_advection = scalar_advection or momentum_advection

    need = max(getattr(momentum_advection, "required_halo", 1),
               getattr(scalar_advection, "required_halo", 1))
    if grid.halo < need:
        raise ValueError(
            f"grid halo {grid.halo} too small for advection (needs {need}); "
            f"build the grid with halo={need}")

    solver = build_anelastic_poisson_solver(
        grid, reference.rho_c, reference.rho_f)

    return AtmosphereModel(
        grid=grid, reference=reference, solver=solver,
        forcing_data=forcing_data,
        constants=constants,
        momentum_advection=momentum_advection,
        scalar_advection=scalar_advection,
        microphysics=microphysics,
        coriolis=coriolis,
        closure=closure,
        forcings=tuple(forcings),
        boundary_fluxes=boundary_fluxes,
        p_standard=p_standard,
        formulation=formulation,
        immersed=immersed,
    )


def initial_state(model: AtmosphereModel,
                  u=None, v=None, w=None,
                  theta=None, T=None, qt=None, tracers=None,
                  enforce_mass_conservation: bool | None = None) -> State:
    """Build a :class:`State` from specific fields (θ or T, qᵗ, velocities).

    Analogue of ``set!(model; u, θ, qᵗ, ...)``
    (``set_atmosphere_model.jl:198``): specific quantities are converted to
    density-weighted prognostics against the reference density; unspecified
    fields default to rest/reference values.

    - ``T``: in-situ temperature as an alternative to θ (name-priority
      conversion via the reference Exner function; vapor-only composition).
    - ``enforce_mass_conservation``: apply one pressure projection to the
      just-set momenta so the initial velocity satisfies the anelastic
      constraint (reference ``enforce_mass_conservation!``,
      ``set_atmosphere_model.jl:121``).  Default: on when any velocity was
      specified.
    """
    g = model.grid
    dt = g.dtype
    ref = model.reference
    rho_c = ref.rho_col
    rho_f = ref.rho_f_col

    if T is not None:
        if theta is not None:
            raise ValueError("specify either theta or T, not both")
        # θˡⁱ from T at the reference pressure (condensate-free init):
        # θ = T / Πᵐ(p_r, q) with q = vapor-only from qt.
        from .thermo.states import exner_function
        if callable(T):
            x, y, z = g.xyz_c()
            T_arr = jnp.asarray(T(x, y, z), dt) * jnp.ones(g.shape, dt)
        else:
            T_arr = jnp.asarray(T, dt) * jnp.ones(g.shape, dt)
        if qt is not None and model.has_moisture:
            qv0 = (jnp.asarray(qt(*g.xyz_c()) if callable(qt) else qt, dt)
                   * jnp.ones(g.shape, dt))
        else:
            qv0 = jnp.zeros(g.shape, dt)
        q0 = MoistureMassFractions.vapor_only(qv0)
        Pi = exner_function(ref.p_col, q0, model.constants, model.p_standard)
        theta = T_arr / Pi

    def _field(val, default, column_density):
        if val is None:
            arr = jnp.full(g.shape, default, dt) if jnp.ndim(default) == 0 else default
        elif callable(val):
            x, y, z = g.xyz_c()
            arr = jnp.asarray(val(x, y, z), dt) * jnp.ones(g.shape, dt)
        else:
            # scalars / columns broadcast to the full grid (a (nz,1,1)
            # prognostic would otherwise fail in the flux machinery)
            arr = jnp.broadcast_to(jnp.asarray(val, dt), g.shape)
        return arr * column_density

    # Default θ: the reference profile value θᵣ(z) — for a constant-θ₀
    # reference this is θ₀ everywhere (reference anelastic initialization,
    # anelastic_time_stepping.jl:15-19).
    if theta is None:
        theta_arr = jnp.full(g.shape, ref.potential_temperature, dt)
    elif callable(theta):
        x, y, z = g.xyz_c()
        theta_arr = jnp.asarray(theta(x, y, z), dt) * jnp.ones(g.shape, dt)
    else:
        theta_arr = jnp.asarray(theta, dt) * jnp.ones(g.shape, dt)

    if model.formulation == "static_energy":
        # Convert θ (vapor-only composition) to moist static energy at the
        # reference pressure: e = cᵖᵐT + gz (dry condensate-free init).
        from .thermo.states import static_energy as _se
        q0 = MoistureMassFractions.vapor_only(
            jnp.zeros(g.shape, dt) if qt is None or model.microphysics is None
            else jnp.asarray(qt(*g.xyz_c()) if callable(qt) else qt, dt)
            * jnp.ones(g.shape, dt))
        T0 = temperature_from_theta_li(theta_arr, q0, ref.p_col,
                                       model.constants, model.p_standard)
        chi = _se(T0, g.z_c_col, q0, model.constants)
        rho_theta = chi * rho_c
    else:
        rho_theta = theta_arr * rho_c

    rho_qt = None
    if model.has_moisture:
        rho_qt = _field(qt, 0.0, rho_c) if qt is not None else jnp.zeros(g.shape, dt)

    rho_u, rho_v, rho_w = fl.enforce_wall_normals(
        g, _field(u, 0.0, rho_c), _field(v, 0.0, rho_c), _field(w, 0.0, rho_f))

    # enforce_mass_conservation! — project the just-set momenta onto the
    # anelastic constraint (reference set_atmosphere_model.jl:121).
    if enforce_mass_conservation is None:
        enforce_mass_conservation = any(val is not None for val in (u, v, w))
    if enforce_mass_conservation:
        rho_u, rho_v, rho_w, _ = pressure_projection(
            model, rho_u, rho_v, rho_w, 1.0)

    tracers = dict(tracers or {})
    # Microphysics schemes with prognostic condensate allocate their tracers.
    for name in getattr(model.microphysics, "prognostic_tracer_names", ()):
        tracers.setdefault(name, jnp.zeros(g.shape, dt))
    diagnostics = {
        name: jnp.zeros(g.shape[1:], dt)
        for name in getattr(model.microphysics, "surface_diagnostic_names", ())}

    state = State(
        rho_u=rho_u, rho_v=rho_v, rho_w=rho_w,
        rho_theta=rho_theta, rho_qt=rho_qt,
        tracers=tracers,
        time=jnp.zeros((), dt),
        diagnostics=diagnostics,
    )
    if isinstance(model.microphysics, SaturationAdjustment) and rho_qt is not None:
        # Warm-start temperature carried ACROSS steps: RK3 stage 1 starts
        # the saturation-adjustment Newton from the previous step's
        # converged T (stages 2-3 chain within the step) — every stage
        # runs scheme.warm_iterations trips.  Seeded with the initial
        # diagnosed T so step 1 is warm too.
        aux0 = diagnose(model, state)
        state = state.replace(
            diagnostics={**state.diagnostics, "T_warm": aux0.T})
    from .physics.surface import initialize_surface_filter
    return initialize_surface_filter(model, state)


# ---------------------------------------------------------------------------
# Diagnostics (the functional update_state!)
# ---------------------------------------------------------------------------

def diagnose(model: AtmosphereModel, state: State, T_guess=None) -> Aux:
    """Recover velocities, temperature, and moisture partition from the state.

    Mirrors ``compute_auxiliary_variables!``
    (``update_atmosphere_model_state.jl:206-292``): u = ρu/ρᵣ (ρᵣ is a
    z-profile, so face interpolation along x/y is the identity), θ = ρθ/ρᵣ,
    saturation adjustment for T and the moisture partition, then the
    perturbation-form buoyancy of ``anelastic_buoyancy.jl:36-72``.

    ``T_guess``: warm-start temperature for the saturation-adjustment
    Newton solve (RK3 stages 2-3 pass the previous stage's converged T —
    see ``SaturationAdjustment.warm_iterations``).
    """
    ref = model.reference
    c = model.constants
    rho_c = ref.rho_col
    rho_f = ref.rho_f_col
    p_r = ref.p_col

    u = state.rho_u / rho_c
    v = state.rho_v / rho_c
    w = state.rho_w / rho_f

    if model.formulation == "static_energy":
        return _diagnose_static_energy(model, state, u, v, w, T_guess=T_guess)

    theta = state.rho_theta / rho_c

    if model.has_moisture:
        qt = state.rho_qt / rho_c
        if isinstance(model.microphysics, SaturationAdjustment):
            T, q = saturation_adjust(theta, qt, p_r, c, model.microphysics,
                                     model.p_standard, T_guess=T_guess)
        elif hasattr(model.microphysics, "prognostic_tracer_names"):
            # Prognostic-condensate schemes (Kessler, 1M): the moisture slot
            # is vapor; condensate fractions come from tracer prognostics
            # (reference grid_moisture_fractions, microphysics_interface.jl:611).
            zero = jnp.zeros_like(theta)
            ql = zero
            qi = zero
            mp = model.microphysics
            for name in getattr(mp, "liquid_tracer_names", mp.prognostic_tracer_names):
                ql = ql + state.tracers.get(name, zero) / rho_c
            for name in getattr(mp, "ice_tracer_names", ()):
                qi = qi + state.tracers.get(name, zero) / rho_c
            q = MoistureMassFractions(qt, ql, qi)
            T = temperature_from_theta_li(theta, q, p_r, c, model.p_standard)
        else:
            q = MoistureMassFractions.vapor_only(qt)
            T = temperature_from_theta_li(theta, q, p_r, c, model.p_standard)
    else:
        qt = None
        q = MoistureMassFractions(
            jnp.zeros_like(theta), jnp.zeros_like(theta), jnp.zeros_like(theta))
        T = temperature_from_theta_li(theta, q, p_r, c, model.p_standard)

    # Perturbation-form moist buoyancy: −gρ′ = −g ρᵣ (RᵐᵣTᵣ/(RᵐT) − 1)
    q_ref = ref.moisture_fractions_col()
    Rm_ref = c.mixture_gas_constant(q_ref)
    Rm = c.mixture_gas_constant(q)
    g_accel = c.gravitational_acceleration
    buoyancy_force = -g_accel * rho_c * (Rm_ref * ref.T_col / (Rm * T) - 1.0)

    return Aux(u=u, v=v, w=w, theta=theta, qt=qt, T=T, q=q,
               buoyancy_force=buoyancy_force)


def _diagnose_static_energy(model: AtmosphereModel, state: State, u, v, w,
                            T_guess=None) -> Aux:
    """Static-energy formulation: prognostic ρe (reference
    ``src/StaticEnergyFormulations/``); T from e with saturation adjustment,
    θˡⁱ diagnosed for closures/diagnostics."""
    from .physics.microphysics import saturation_adjust_static_energy
    from .thermo.states import temperature_from_static_energy

    ref = model.reference
    c = model.constants
    rho_c = ref.rho_col
    p_r = ref.p_col
    z = model.grid.z_c_col

    e = state.rho_theta / rho_c     # thermodynamic density slot holds ρe

    if model.has_moisture:
        qt = state.rho_qt / rho_c
        if isinstance(model.microphysics, SaturationAdjustment):
            T, q = saturation_adjust_static_energy(e, z, qt, p_r, c,
                                                   model.microphysics,
                                                   T_guess=T_guess)
        else:
            q = MoistureMassFractions.vapor_only(qt)
            T = temperature_from_static_energy(e, z, q, c)
    else:
        qt = None
        zero = jnp.zeros_like(e)
        q = MoistureMassFractions(zero, zero, zero)
        T = temperature_from_static_energy(e, z, q, c)

    theta = theta_li_from_temperature(T, q, p_r, c, model.p_standard)

    q_ref = ref.moisture_fractions_col()
    Rm_ref = c.mixture_gas_constant(q_ref)
    Rm = c.mixture_gas_constant(q)
    g_acc = c.gravitational_acceleration
    buoyancy_force = -g_acc * rho_c * (Rm_ref * ref.T_col / (Rm * T) - 1.0)

    return Aux(u=u, v=v, w=w, theta=theta, qt=qt, T=T, q=q,
               buoyancy_force=buoyancy_force)


def _padded_reference_columns(model: AtmosphereModel):
    """z-halo-padded reference-density columns, broadcastable to padded fields.

    The center column pads with the even mirror (matching the CCC halo
    rule); the face column pads evenly about the wall faces so that the
    product ``ρᶠ_pad × w_pad`` reproduces the odd-reflected pad of ρw.
    Horizontal pads are trivial for a z-profile (wrap/mirror of a constant).
    """
    g = model.grid
    h = g.halo
    ref = model.reference
    rc = ref.rho_c
    rf = ref.rho_f            # faces 0..nz (nz+1 values)

    from .grid import Topology
    if g.z_topology == Topology.BOUNDED:
        c_pad = jnp.concatenate([rc[:h][::-1], rc, rc[-h:][::-1]])
        # stored w faces are 0..nz-1; ghosts mirror about faces 0 and nz
        f_low = rf[1:h + 1][::-1]
        f_high = jnp.concatenate([rf[g.nz:g.nz + 1], rf[g.nz - h + 1:g.nz][::-1]])
        f_pad = jnp.concatenate([f_low, rf[:g.nz], f_high])
    else:
        c_pad = jnp.concatenate([rc[-h:], rc, rc[:h]])
        f_pad = jnp.concatenate([rf[:g.nz][-h:], rf[:g.nz], rf[:g.nz][:h]])
    return c_pad[:, None, None], f_pad[:, None, None]


# ---------------------------------------------------------------------------
# Tendencies
# ---------------------------------------------------------------------------

def compute_tendencies(model: AtmosphereModel, state: State, aux: Aux | None = None,
                       dt=None):
    """Right-hand sides for every prognostic field.

    Mirrors ``compute_tendencies!`` (``update_atmosphere_model_state.jl:
    294-387``) + the kernel functions in ``dynamics_kernel_functions.jl``:
    flux-form advection, Coriolis, closure stress divergence, buoyancy
    (z-faces), scalar flux divergences, forcings, and surface-flux BC
    contributions.  Anelastic: no PGF here — pressure enters via projection.

    ``dt`` (float or traced scalar) activates the AIVA explicit-flux CFL scaling when
    an advection scheme is wrapped in
    :class:`~breeze_tpu.advection.AdaptiveImplicitVerticalAdvection`; the
    implicit remainder is applied by the stepper
    (``dynamics/vertical_implicit.py``).  With ``dt=None`` AIVA schemes run
    fully explicit.
    """
    if aux is None:
        aux = diagnose(model, state)
    g = model.grid
    so = model.stencil_ops()
    ref = model.reference

    # AIVA unwrap: explicit fluxes use the inner scheme with the CFL-scaled
    # vertical flux (reference implicit_vertical_advection.jl:120-165).
    mom_scheme = model.momentum_advection
    scal_scheme = model.scalar_advection
    z_scales_mom = None
    z_scale_scal = None
    if isinstance(mom_scheme, adv.AdaptiveImplicitVerticalAdvection):
        if dt is not None:
            from .dynamics.vertical_implicit import aiva_split
            sp = aiva_split(g, aux.w, dt, mom_scheme.cfl)
            z_scales_mom = (sp.s_u, sp.s_v, sp.s_w)
            if scal_scheme is mom_scheme:
                z_scale_scal = sp.s_scal
        mom_scheme = mom_scheme.scheme
    if isinstance(scal_scheme, adv.AdaptiveImplicitVerticalAdvection):
        if dt is not None and z_scale_scal is None:
            from .dynamics.vertical_implicit import aiva_split
            z_scale_scal = aiva_split(g, aux.w, dt,
                                      scal_scheme.cfl).s_scal
        scal_scheme = scal_scheme.scheme

    # Partial-cell bottom: 3-D z-divergence thickness through the advection
    # operators (reference PartialCellBottom; see dynamics/immersed.py).
    from .dynamics.immersed import PartialCellBottom
    pcb = model.immersed if isinstance(model.immersed,
                                       PartialCellBottom) else None

    # Anelastic: ρu = ρᵣ(z)·u with a z-only profile, so the padded momentum
    # is the padded velocity times a z-padded COLUMN — a fused broadcast
    # multiply instead of three full-field halo materializations.
    rho_c_padcol, rho_f_padcol = _padded_reference_columns(model)
    u_pad = fl.pad(aux.u, g, fl.CCF)
    v_pad = fl.pad(aux.v, g, fl.CFC)
    w_pad = fl.pad(aux.w, g, fl.FCC)
    rho_u_pad = u_pad * rho_c_padcol
    rho_v_pad = v_pad * rho_c_padcol
    rho_w_pad = w_pad * rho_f_padcol

    tracer_names = list(state.tracers.keys())

    # Momentum advection: ∇·(ρU ⊗ u)
    adv_u, adv_v, adv_w = adv.momentum_flux_divergence(
        so, mom_scheme,
        rho_u_pad, rho_v_pad, rho_w_pad, u_pad, v_pad, w_pad,
        z_scales=z_scales_mom,
        z_spacings=(None if pcb is None
                    else (pcb.dz_u3, pcb.dz_v3, None)))

    cor_x, cor_y, cor_z = coriolis_terms(
        model.coriolis, so, rho_u_pad, rho_v_pad, rho_w_pad, g)

    G_rho_u = -adv_u - cor_x
    G_rho_v = -adv_v - cor_y
    # Buoyancy interpolated center→z-face (buoyancy_forceᶜᶜᶠ,
    # dynamics_kernel_functions.jl:42).
    b_pad = fl.pad(aux.buoyancy_force, g, fl.CCC)
    G_rho_w = -adv_w - cor_z + so.iz_cf(b_pad)

    # Scalars: θ and qᵗ advected as specific quantities against ρᵣ
    # (potential_temperature_tendency.jl:100-105; scalar_tendency
    # dynamics_kernel_functions.jl:132-159).  The density is the z-padded
    # reference COLUMN — broadcasting through the flux machinery without a
    # full-field halo materialization.
    rho_r_pad = rho_c_padcol

    def scalar_div(c_spec):
        c_pad = fl.pad(c_spec, g, fl.CCC)
        return adv.div_rho_u_c(
            so, scal_scheme, rho_r_pad, u_pad, v_pad, w_pad, c_pad,
            z_flux_scale=z_scale_scal,
            z_spacing=None if pcb is None else pcb.dz_c3,
            face_fractions=None if pcb is None
            else (pcb.frac_u, pcb.frac_v, pcb.frac_c))

    # Specific thermodynamic prognostic: θˡⁱ or e (formulation dispatch,
    # reference formulation_interface.jl:22-208).
    chi = state.rho_theta / ref.rho_col
    G_rho_theta = -scalar_div(chi)

    G_rho_qt = None
    if model.has_moisture:
        G_rho_qt = -scalar_div(aux.qt)

    G_tracers = {}
    for name in tracer_names:
        G_tracers[name] = -scalar_div(state.tracers[name] / ref.rho_col)

    if model.formulation == "static_energy":
        # −ρwb buoyancy flux couples energy and momentum budgets in the
        # anelastic limit (reference static_energy_tendency.jl:60-72).
        b_f = so.iz_cf(fl.pad(aux.buoyancy_force, g, fl.CCC))  # ρb at z-faces
        wb_pad = fl.pad(aux.w * b_f, g, fl.FCC)
        G_rho_theta = G_rho_theta - so.iz_fc(wb_pad)

    # Closure (SGS) stress divergence and diffusive scalar fluxes.
    if model.closure is not None:
        from .physics.closures import closure_tendencies
        closure_fluxes = closure_tendencies(
            model, so, aux, u_pad, v_pad, w_pad)
        G_rho_u = G_rho_u + closure_fluxes.G_u
        G_rho_v = G_rho_v + closure_fluxes.G_v
        G_rho_w = G_rho_w + closure_fluxes.G_w
        if closure_fluxes.G_theta is not None:
            G_rho_theta = G_rho_theta + closure_fluxes.G_theta
        if model.has_moisture and closure_fluxes.G_qt is not None:
            G_rho_qt = G_rho_qt + closure_fluxes.G_qt

    G = State(
        rho_u=G_rho_u, rho_v=G_rho_v, rho_w=G_rho_w,
        rho_theta=G_rho_theta, rho_qt=G_rho_qt, tracers=G_tracers,
        time=jnp.zeros_like(state.time),
    )

    # Surface flux boundary conditions enter as tendencies on the
    # wall-adjacent cells (compute_flux_bc_tendencies!, reference
    # update_atmosphere_model_state.jl:418-434).
    if model.boundary_fluxes is not None:
        from .physics.surface import apply_boundary_flux_tendencies
        G = apply_boundary_flux_tendencies(model, state, aux, G)

    # User forcings (geostrophic, subsidence, sponges...).
    for forcing in model.forcings:
        G = forcing(model, state, aux, G)

    # Immersed boundary: no evolution inside the solid (reference
    # inactive_cell masking in every tendency kernel).
    if model.immersed is not None:
        from .dynamics.immersed import mask_tendencies
        G = mask_tendencies(model.immersed, G)

    return G


def stage_update(model: AtmosphereModel, state: State, state0: State,
                 dt, alpha, aux: Aux | None = None) -> State:
    """One SSP-RK3 stage blend (pre-projection): returns the State with
    every prognostic at (1−α)s⁰ + α(s + Δt·G) (reference substep formula,
    ``ssp_runge_kutta_3.jl:165-172``)."""
    G = compute_tendencies(model, state, aux, dt=dt)

    def sub(s, s0, gg):
        return (1.0 - alpha) * s0 + alpha * (s + dt * gg)

    return State(
        rho_u=sub(state.rho_u, state0.rho_u, G.rho_u),
        rho_v=sub(state.rho_v, state0.rho_v, G.rho_v),
        rho_w=sub(state.rho_w, state0.rho_w, G.rho_w),
        rho_theta=sub(state.rho_theta, state0.rho_theta, G.rho_theta),
        rho_qt=(None if state.rho_qt is None
                else sub(state.rho_qt, state0.rho_qt, G.rho_qt)),
        tracers={k: sub(state.tracers[k], state0.tracers[k], G.tracers[k])
                 for k in state.tracers},
        time=state.time,
    )


# ---------------------------------------------------------------------------
# Pressure projection
# ---------------------------------------------------------------------------

def pressure_projection(model: AtmosphereModel, rho_u, rho_v, rho_w, dt):
    """Project predicted momentum onto ∇·(ρᵣu) = 0.

    Mirrors ``compute_pressure_correction!`` + ``make_pressure_correction!``
    (``anelastic_time_stepping.jl:26-78``): solve ∇·(ρᵣ∇φ) = ∇·(ρũ)/Δt,
    then ρu ← ρu − Δt ρᵣ ∇φ with ρᵣ at each component's location.

    Returns ``(rho_u, rho_v, rho_w, phi)``.
    """
    g = model.grid
    so = model.stencil_ops()

    rho_u, rho_v, rho_w = fl.enforce_wall_normals(g, rho_u, rho_v, rho_w)
    if model.immersed is not None:
        # mask momenta on solid faces before the divergence (reference
        # compute_pressure_correction!: mask_immersed + fill halos first)
        ib = model.immersed
        rho_u = rho_u * ib.mask_u
        rho_v = rho_v * ib.mask_v
        rho_w = rho_w * ib.mask_w

    rho_c = model.reference.rho_col
    rho_f = model.reference.rho_f_col

    # δ = ∇·(ρu) at centers (1-wide halos suffice).
    ru_pad = fl.pad(rho_u, g, fl.CCF)
    rv_pad = fl.pad(rho_v, g, fl.CFC)
    rw_pad = fl.pad(rho_w, g, fl.FCC)
    div = so.div_c(ru_pad, rv_pad, rw_pad)

    with jax.named_scope("poisson_solve"):
        phi = model.solver.solve(div, dt)

    phi_pad = fl.pad(phi, g, fl.CCC)
    rho_u = rho_u - dt * rho_c * so.dx_cf(phi_pad)
    rho_v = rho_v - dt * rho_c * so.dy_cf(phi_pad)
    rho_w = rho_w - dt * rho_f * so.dz_cf(phi_pad)
    rho_u, rho_v, rho_w = fl.enforce_wall_normals(g, rho_u, rho_v, rho_w)
    if model.immersed is not None:
        ib = model.immersed
        rho_u = rho_u * ib.mask_u
        rho_v = rho_v * ib.mask_v
        rho_w = rho_w * ib.mask_w
    return rho_u, rho_v, rho_w, phi
