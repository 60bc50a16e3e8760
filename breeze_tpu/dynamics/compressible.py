"""Compressible dynamics: prognostic density, EOS pressure, split-explicit HEVI.

Re-design of reference ``src/CompressibleEquations/`` (dynamics
``compressible_dynamics.jl:44-301``, acoustic substepper
``acoustic_substepping.jl`` — 1551 LoC of kernels — and the WS-RK3 outer
loop ``acoustic_runge_kutta_3.jl``), following the scheme specification in
``docs/src/compressible_dynamics.md``:

- Wicker–Skamarock RK3 outer stages β = (1/3, 1/2, 1); slow tendencies
  (advection, Coriolis, closures, forcings — NO pressure gradient/buoyancy)
  evaluated once per stage at the stage-entry state U^L and held fixed.
- Inner acoustic loop advances *perturbations* about U^L: forward-Euler
  horizontal momenta (MPAS first-substep gating of the perturbation PGF),
  off-centered Crank–Nicolson vertical (ρw)' via a batched tridiagonal
  Schur solve (ω = 0.65 default), predictor/recovery for ρ', (ρθ)', and
  Klemp-2018 horizontal divergence damping.
- Stage rewind: perturbations initialize to U^n − U^L so every stage's loop
  starts from the step-start state (WS-RK3 invariant).
- Scalars (moisture, tracers) advect over βΔt with the substep
  time-averaged momentum ⟨ρu⟩ (WRF/MPAS split).

The whole outer step is one pure jitted function: the substep loop is a
``lax.fori_loop`` whose body is fused elementwise/stencil work + one
tridiagonal scan — the design target from SURVEY.md §7 hard-part 1.
"""

from __future__ import annotations

import dataclasses
import math
import os
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from .. import advection as adv
from .. import fields as fl
from ..grid import Grid, Topology
from ..ops import StencilOps
from ..physics.coriolis import coriolis_terms
from ..thermo.constants import ThermodynamicConstants
from ..thermo.reference import ExnerReferenceState, make_exner_reference_state
from .tridiagonal import thomas_solve


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NoDivergenceDamping:
    """No acoustic divergence damping (reference
    ``time_discretizations.jl:229-240``)."""


@dataclasses.dataclass(frozen=True)
class ThermalDivergenceDamping:
    """Klemp, Skamarock & Ha (2018) divergence damping via the discrete
    δτ(ρθ) substep tendency as a divergence proxy (reference
    ``time_discretizations.jl:241-274``).  ``damp_vertical`` folds a
    vertical damping into the column tridiagonal (reference default off —
    the CN off-centering ω>0.5 is algebraically equivalent, KSH18 eq. 32).
    """

    coefficient: float = 0.1
    damp_vertical: bool = False


@dataclasses.dataclass(frozen=True)
class DirectDivergenceDamping:
    """Divergence damping from the horizontal θ-flux divergence formed
    DIRECTLY from the perturbation momentum (KSH18 eq. 36; MPAS
    ``config_smdiv``) — no 1/Δτ in the diffusivity, avoiding the thermal
    proxy's cold-start spurious force (reference
    ``time_discretizations.jl:276-300``).
    """

    coefficient: float = 0.1


def _ramp_profile(kind: str, z, top, depth):
    """Sponge ramp value in [0,1] (reference ``AbstractRamp`` family,
    ``time_discretizations.jl:387-437``)."""
    s = jnp.clip((z - (top - depth)) / depth, 0.0, 1.0)
    if kind == "linear":
        return s
    if kind == "sin2":
        return jnp.sin(0.5 * jnp.pi * s) ** 2
    if kind == "cubic":
        return s * s * (3.0 - 2.0 * s)
    raise ValueError(f"unknown ramp {kind!r}")


@dataclasses.dataclass(frozen=True)
class UpperSponge:
    """Implicit upper Rayleigh sponge inside the substep loop's column
    tridiagonal (reference ``UpperSponge``, ``time_discretizations.jl:
    439-507``; Klemp, Dudhia & Hassiotis 2008): CN-weighted — ωΔτ·rate·ramp
    on the diagonal, (1−ω)Δτ·rate·ramp·(ρw)′ on the explicit RHS.
    Unconditionally stable for any positive rate.

    ``damp_full`` (default True): ALSO damp the stage-entry (ρw)ᴸ — the
    KDH08 eq. (5) semantics, where the Rayleigh term acts on the full
    wᵗ⁺ᐃᵗ.  The reference damps only the substep PERTURBATION
    (``acoustic_substepping.jl:552-563``), which cannot absorb a wave that
    has already accumulated in the layer: measured on the Schär mountain
    case, max|w| grows without bound INSIDE a perturbation-only sponge
    (exponential with Centered(2) advection, ~20 m/s saturated-by-breaking
    with WENO5), while the full-field form absorbs it.  Set
    ``damp_full=False`` for reference-parity behavior.
    """

    damping_rate: float = 0.2
    depth: float = 5.0e3
    ramp: str = "cubic"     # "cubic" | "sin2" | "linear"
    damp_full: bool = True


@dataclasses.dataclass(frozen=True)
class SplitExplicitTimeDiscretization:
    """Split-explicit (HEVI) time discretization controls.

    Mirrors reference ``SplitExplicitTimeDiscretization``
    (``time_discretizations.jl:535-590``): ``substeps`` N fixes Δτ = Δt/N;
    ``forward_weight`` is the CN off-centering ω; ``damping_coefficient``
    the Klemp α (0 disables); ``acoustic_cfl`` sizes N when ``substeps``
    is None (computed host-side from a static Δt).

    ``damping`` selects the divergence-damping strategy (None → legacy
    :class:`ThermalDivergenceDamping` with ``damping_coefficient``);
    ``sponge`` an optional :class:`UpperSponge`; ``substep_distribution``
    one of ``"proportional"`` (Nτ=⌈βN⌉, Δτ fitted to tile βΔt exactly),
    ``"constant"`` (N rounded to a multiple of 6, uniform Δτ=Δt/N), or
    ``"monolithic_first"`` (stage 1 = one Δt/3 substep) — reference
    ``AcousticSubstepDistribution`` (``time_discretizations.jl:60-117``).
    """

    substeps: int | None = None
    acoustic_cfl: float = 0.5
    forward_weight: float = 0.65
    damping_coefficient: float = 0.1
    reference_sound_temperature: float = 300.0
    # Reduced-precision storage for the substep working fields (reference's
    # ``substep_floattype``, acoustic_substepping.jl:165-187): halves the HBM
    # traffic of the inner loop; compute stays in the grid dtype.
    substep_floattype: str | None = None    # e.g. "bfloat16"
    damping: Any = None
    sponge: UpperSponge | None = None
    substep_distribution: str = "proportional"
    # Per-substep relaxation factor α ∈ (0, 1] for ρ′/(ρθ)′ at the outermost
    # cells of axes with an OpenBoundaryRelaxation forcing (reference
    # ``open_boundary_relaxation``, time_discretizations.jl:343-346 and
    # ``apply_open_boundary_relaxation!``, acoustic_substepping.jl:1279-1322;
    # default 0.5 ≈ FV3-LAM's outermost-blend-row weight).
    open_boundary_relaxation: float = 0.5

    def damping_strategy(self):
        if self.damping is not None:
            return self.damping
        if self.damping_coefficient:
            return ThermalDivergenceDamping(self.damping_coefficient)
        return NoDivergenceDamping()


@dataclasses.dataclass(frozen=True)
class ExplicitTimeStepping:
    """Fully explicit compressible stepping (3-D acoustic CFL limited)."""


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["rho", "rho_u", "rho_v", "rho_w", "rho_theta", "rho_qt",
                 "tracers", "time", "diagnostics"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class CompressibleState:
    """Prognostics: dry density ρᵈ + momentum + ρθ (+ moisture, tracers).

    Mirrors reference compressible prognostic set (ρᵈ prognostic,
    ``compressible_dynamics.jl:454``; total ρ diagnosed).
    """

    rho: jax.Array
    rho_u: jax.Array
    rho_v: jax.Array
    rho_w: jax.Array
    rho_theta: jax.Array
    rho_qt: jax.Array | None
    tracers: dict[str, jax.Array]
    time: jax.Array
    diagnostics: dict[str, jax.Array] = dataclasses.field(default_factory=dict)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["grid", "reference", "terrain"],
    meta_fields=["constants", "momentum_advection", "scalar_advection",
                 "coriolis", "closure", "forcings", "boundary_fluxes",
                 "time_discretization", "p_standard", "microphysics",
                 "formulation"],
)
@dataclasses.dataclass(frozen=True)
class CompressibleModel:
    grid: Grid
    reference: ExnerReferenceState
    constants: ThermodynamicConstants
    momentum_advection: Any
    scalar_advection: Any
    coriolis: Any
    closure: Any
    forcings: tuple
    boundary_fluxes: Any
    time_discretization: Any
    p_standard: float
    microphysics: Any = None   # None (dry) | SaturationAdjustment (moist)
    # Terrain-following σ-coordinates (TerrainMetrics | None): when set, the
    # split-explicit core runs the σ-coordinate dispatch (reference
    # ``terrain_compressible_physics.jl:486-659``).
    terrain: Any = None
    # Thermodynamic formulation: "potential_temperature" (ρθˡⁱ) or
    # "static_energy" (ρe).  The ``rho_theta`` state slot generically holds
    # the formulation's thermodynamic density ρχ, matching the reference's
    # generic slot (``thermodynamic_density(model.formulation)``,
    # ``acoustic_substepping.jl:746-747``); see :func:`stage_caches` for the
    # per-formulation fast-system linearization.
    formulation: str = "potential_temperature"

    @property
    def has_moisture(self):
        return self.microphysics is not None

    def stencil_ops(self) -> StencilOps:
        return StencilOps(self.grid)


def make_compressible_model(
    grid: Grid,
    constants: ThermodynamicConstants | None = None,
    reference: ExnerReferenceState | None = None,
    advection=None,
    momentum_advection=None,
    scalar_advection=None,
    coriolis=None,
    closure=None,
    forcings=(),
    boundary_fluxes=None,
    time_discretization=None,
    microphysics=None,
    terrain=None,
    formulation: str = "potential_temperature",
    surface_pressure: float = 101325.0,
    reference_potential_temperature=300.0,
    reference_vapor_mass_fraction=None,
    p_standard: float = 1.0e5,
) -> CompressibleModel:
    constants = constants or ThermodynamicConstants()
    if reference is None:
        reference = make_exner_reference_state(
            grid, constants,
            surface_pressure=surface_pressure,
            potential_temperature=reference_potential_temperature,
            vapor_mass_fraction=reference_vapor_mass_fraction,
            standard_pressure=p_standard)
    if advection is not None:
        momentum_advection = momentum_advection or advection
        scalar_advection = scalar_advection or advection
    momentum_advection = momentum_advection or adv.Centered(2)
    scalar_advection = scalar_advection or momentum_advection
    time_discretization = time_discretization or SplitExplicitTimeDiscretization()
    if formulation not in ("potential_temperature", "static_energy"):
        raise ValueError(f"unknown formulation {formulation!r}")
    if formulation == "static_energy" and terrain is not None:
        raise NotImplementedError(
            "static_energy formulation with terrain-following coordinates "
            "is not wired (the terrain slow-tendency path advects θ; no "
            "reference evidence of terrain+ρe either)")
    return CompressibleModel(
        grid=grid, reference=reference, constants=constants,
        momentum_advection=momentum_advection,
        scalar_advection=scalar_advection,
        coriolis=coriolis, closure=closure, forcings=tuple(forcings),
        boundary_fluxes=boundary_fluxes,
        time_discretization=time_discretization,
        p_standard=p_standard,
        microphysics=microphysics,
        terrain=terrain,
        formulation=formulation,
    )


def compressible_initial_state(model: CompressibleModel, theta=None, u=None,
                               v=None, w=None, rho=None, qt=None,
                               pressure_balanced: bool = True) -> CompressibleState:
    """Initialize from θ (+ optional velocity) against the reference column.

    By default uses pressure-balanced density ρ = ρᵣ θ̄/θ (reference
    ``pressure_balanced_density``, ``reference_states.jl:140-160``) so a θ
    perturbation leaves ρθ — and hence the diagnosed pressure — unchanged,
    avoiding spurious acoustic noise at startup.
    """
    g = model.grid
    dt = g.dtype
    ref = model.reference

    def materialize(val, default):
        if val is None:
            return jnp.full(g.shape, default, dt) if jnp.ndim(default) == 0 else (
                jnp.broadcast_to(default, g.shape).astype(dt))
        if callable(val):
            x, y, z = g.xyz_c()
            return (jnp.asarray(val(x, y, z), dt) * jnp.ones(g.shape, dt))
        return jnp.broadcast_to(jnp.asarray(val, dt), g.shape).astype(dt)

    theta_arr = materialize(theta, ref.theta_col * jnp.ones(g.shape, dt))
    if rho is None:
        if pressure_balanced:
            rho_arr = ref.rho_col * ref.theta_col / theta_arr
        else:
            rho_arr = jnp.broadcast_to(ref.rho_col, g.shape).astype(dt)
    else:
        rho_arr = materialize(rho, 0.0)

    rho_f = 0.5 * (rho_arr + jnp.concatenate([rho_arr[:1], rho_arr[:-1]], 0))

    u_arr = materialize(u, 0.0)
    v_arr = materialize(v, 0.0)
    w_arr = materialize(w, 0.0)
    rho_u_arr, rho_v_arr, rho_w = fl.enforce_wall_normals(
        g, rho_arr * u_arr, rho_arr * v_arr, rho_f * w_arr)

    rho_qt = None
    tracers = {}
    if model.has_moisture:
        qt_arr = materialize(qt, 0.0) if qt is not None else jnp.zeros(g.shape, dt)
        rho_qt = rho_arr * qt_arr
        for name in getattr(model.microphysics, "prognostic_tracer_names", ()):
            tracers.setdefault(name, jnp.zeros(g.shape, dt))
    diagnostics = {
        name: jnp.zeros(g.shape[1:], dt)
        for name in getattr(model.microphysics, "surface_diagnostic_names", ())}

    rho_chi = rho_arr * theta_arr
    if model.formulation == "static_energy":
        # ρe from the θ initialization: invert θˡⁱ at the TRUE density
        # (p = ρRᵐT) then e = cᵖᵐT + gz − ℒq (reference
        # ``set_thermodynamic_variable!(::StaticEnergyModel, ::Val{:θ})``,
        # ``static_energy_tendency.jl:92-110``).
        from ..physics.microphysics import density_temperature_inversion
        from ..thermo.constants import MoistureMassFractions
        from ..thermo.states import static_energy
        zero = jnp.zeros(g.shape, dt)
        qt_frac = (rho_qt / rho_arr) if rho_qt is not None else zero
        q0 = MoistureMassFractions.vapor_only(qt_frac)
        T0, _ = density_temperature_inversion(theta_arr, rho_arr, q0,
                                              model.constants,
                                              model.p_standard)
        rho_chi = rho_arr * static_energy(T0, g.z_c_col, q0, model.constants)

    state = CompressibleState(
        rho=rho_arr,
        rho_u=rho_u_arr,
        rho_v=rho_v_arr,
        rho_w=rho_w,
        rho_theta=rho_chi,
        rho_qt=rho_qt, tracers=tracers,
        time=jnp.zeros((), dt),
        diagnostics=diagnostics,
    )
    from ..physics.surface import initialize_surface_filter
    return initialize_surface_filter(model, state)


# ---------------------------------------------------------------------------
# EOS and diagnostics
# ---------------------------------------------------------------------------

def eos_pressure(model: CompressibleModel, rho_theta):
    """Dry EOS closed form: p = pˢᵗ (Rᵈ ρθ / pˢᵗ)^{γᵈ}.

    Derived from p = ρRᵈT, T = θΠ, Π = (p/pˢᵗ)^κ (reference
    ``compressible_time_stepping.jl:161-244``, dry closed-form branch).
    """
    c = model.constants
    Rd = c.Rd
    cpd = c.dry_air.heat_capacity
    gamma = cpd / (cpd - Rd)
    p_st = model.p_standard
    return p_st * (Rd * rho_theta / p_st) ** gamma


class CompAux(NamedTuple):
    u: jax.Array
    v: jax.Array
    w: jax.Array
    theta: jax.Array
    p: jax.Array
    T: jax.Array
    q: Any = None      # MoistureMassFractions | None
    qt: Any = None


def compressible_diagnose(model: CompressibleModel, state: CompressibleState) -> CompAux:
    """u = ρu/ρ̄ᶠ (3-D face interpolation now), θ = ρθ/ρ, p from EOS.

    Moist path: density-based saturation adjustment (T, q, p) from
    (ρ, θˡⁱ, qᵗ) — the reference's LiquidIceDensityState Newton inversion
    (``compressible_time_stepping.jl:161-244``)."""
    g = model.grid
    rho_pad = fl.pad(state.rho, g, fl.CCC, halo=1, axes=(0, 1, 2))

    def v1(a, dz=0, dy=0, dx=0):
        nz, ny, nx = g.shape
        return a[1 + dz:1 + dz + nz, 1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx]

    rho_x = 0.5 * (v1(rho_pad) + v1(rho_pad, dx=-1))
    rho_y = 0.5 * (v1(rho_pad) + v1(rho_pad, dy=-1))
    rho_z = 0.5 * (v1(rho_pad) + v1(rho_pad, dz=-1))
    u = state.rho_u / rho_x
    v = state.rho_v / rho_y
    w = state.rho_w / rho_z

    if model.formulation == "static_energy":
        return _compressible_diagnose_static_energy(model, state, u, v, w)

    theta = state.rho_theta / state.rho

    if model.has_moisture:
        from ..physics.microphysics import (SaturationAdjustment,
                                            density_saturation_adjust,
                                            density_temperature_inversion)
        from ..thermo.constants import MoistureMassFractions

        qt = state.rho_qt / state.rho
        mp = model.microphysics
        if isinstance(mp, SaturationAdjustment):
            T, q, p = density_saturation_adjust(theta, state.rho, qt,
                                                model.constants, mp,
                                                model.p_standard)
        else:
            # Prognostic-condensate schemes (Kessler, 1M/2M): the moisture
            # slot is vapor, condensate comes from tracers; T from the
            # fixed-partition density inversion (reference grid moisture
            # fractions, microphysics_interface.jl:611).
            zero = jnp.zeros_like(theta)
            ql = zero
            qi = zero
            for name in getattr(mp, "liquid_tracer_names",
                                getattr(mp, "prognostic_tracer_names", ())):
                ql = ql + state.tracers.get(name, zero) / state.rho
            for name in getattr(mp, "ice_tracer_names", ()):
                qi = qi + state.tracers.get(name, zero) / state.rho
            q = MoistureMassFractions(qt, ql, qi)
            T, p = density_temperature_inversion(
                theta, state.rho, q, model.constants, model.p_standard,
                getattr(mp, "iterations", 5))
        return CompAux(u=u, v=v, w=w, theta=theta, p=p, T=T, q=q, qt=qt)

    p = eos_pressure(model, state.rho_theta)
    T = p / (model.constants.Rd * state.rho)
    return CompAux(u=u, v=v, w=w, theta=theta, p=p, T=T)


def reference_static_energy_col(model: CompressibleModel):
    """Dry reference static-energy column e_r = cᵖᵈT_r + gz — the SAME
    arithmetic as the θ-path of :func:`compressible_initial_state`, so a
    rest state has ρe ≡ ρ_r e_r bitwise and the perturbation-form T
    recovery below cancels exactly."""
    from ..thermo.constants import MoistureMassFractions
    from ..thermo.states import static_energy
    ref = model.reference
    zero = jnp.zeros_like(ref.T_col)
    q0 = MoistureMassFractions.vapor_only(zero)
    return static_energy(ref.T_col, model.grid.z_c_col, q0, model.constants)


def _compressible_diagnose_static_energy(model: CompressibleModel,
                                         state: CompressibleState,
                                         u, v, w) -> CompAux:
    """Static-energy (ρe) diagnostics on the compressible core.

    The reference's substepper is formulation-generic
    (``acoustic_substepping.jl:746-747``) but its compressible T/p
    diagnostic dispatch covers only θˡⁱ (``compressible_time_stepping.jl:
    216-252``); this completes the design.  T is recovered in PERTURBATION
    form against the dry reference column,

        T = T_r + (e − e_r + ℒˡqˡ + ℒⁱqⁱ + (cᵖᵈ − cᵖᵐ)T_r) / cᵖᵐ,

    algebraically identical to (e − gz + ℒq)/cᵖᵐ but free of the
    gz-magnitude float cancellation (e ~ 3e5 J/kg ≫ cᵖΔT resolution), and
    bitwise T = T_r at a dry rest state.  p = ρRᵐT (true EOS).
    """
    g = model.grid
    c = model.constants
    ref = model.reference
    from ..thermo.constants import MoistureMassFractions
    from ..thermo.states import theta_li_from_temperature

    e = state.rho_theta / state.rho          # slot holds ρe
    e_r = reference_static_energy_col(model)
    cpd = c.dry_air.heat_capacity
    Ll = c.liquid.reference_latent_heat
    Li = c.ice.reference_latent_heat

    if model.has_moisture:
        from ..physics.microphysics import (
            SaturationAdjustment, density_saturation_adjust_static_energy)
        qt = state.rho_qt / state.rho
        mp = model.microphysics
        if isinstance(mp, SaturationAdjustment):
            T, q, p = density_saturation_adjust_static_energy(
                e, g.z_c_col, state.rho, qt, c, mp)
        else:
            zero = jnp.zeros_like(e)
            ql = zero
            qi = zero
            for name in getattr(mp, "liquid_tracer_names",
                                getattr(mp, "prognostic_tracer_names", ())):
                ql = ql + state.tracers.get(name, zero) / state.rho
            for name in getattr(mp, "ice_tracer_names", ()):
                qi = qi + state.tracers.get(name, zero) / state.rho
            q = MoistureMassFractions(qt, ql, qi)
            cpm = c.mixture_heat_capacity(q)
            T = ref.T_col + (e - e_r + Ll * q.liquid + Li * q.ice
                             + (cpd - cpm) * ref.T_col) / cpm
            p = state.rho * c.mixture_gas_constant(q) * T
        theta = theta_li_from_temperature(T, q, p, c, model.p_standard)
        return CompAux(u=u, v=v, w=w, theta=theta, p=p, T=T, q=q, qt=qt)

    T = ref.T_col + (e - e_r) / cpd
    p = state.rho * c.Rd * T
    zero = jnp.zeros_like(e)
    q0 = MoistureMassFractions(zero, zero, zero)
    theta = theta_li_from_temperature(T, q0, p, c, model.p_standard)
    return CompAux(u=u, v=v, w=w, theta=theta, p=p, T=T)


# ---------------------------------------------------------------------------
# Slow tendencies (PGF and buoyancy excluded; stage-entry imbalance for w)
# ---------------------------------------------------------------------------

class SlowTendencies(NamedTuple):
    rho: jax.Array
    rho_u: jax.Array
    rho_v: jax.Array
    rho_w: jax.Array
    rho_theta: jax.Array
    # Slow NON-advective moisture sources (closure diffusion, surface
    # fluxes, forcings); advection is applied separately over βΔt with the
    # substep time-averaged momentum (``_advance_scalars``).
    rho_qt: jax.Array | None = None
    # Eddy coefficients at the stage-entry state, carried to the
    # vertically-implicit stage solve (``implicit_substep!``).
    nu_e: jax.Array | None = None
    kappa_e: jax.Array | None = None


def latlon_curvature_terms(g, so, state, u_pad, v_pad, rho_u_pad):
    """Spherical curvature terms (shallow-atmosphere, traditional):
    +ρuv tanφ/R on zonal momentum, −ρu² tanφ/R on meridional (reference:
    Oceananigans ``U_dot_∇u`` metric terms on curvilinear grids,
    ``dynamics_kernel_functions.jl:54-62``).  Returns (du, dv) to ADD to
    the momentum tendencies; shared by the flat and terrain paths."""
    tan_c = g.tanlat_c[None, :, None]
    tan_f = g.tanlat_f[: g.ny][None, :, None]
    inv_R = 1.0 / g.radius
    v_at_u = 0.25 * (so.v(v_pad) + so.v(v_pad, dy=1)
                     + so.v(v_pad, dx=-1) + so.v(v_pad, dy=1, dx=-1))
    du = state.rho_u * v_at_u * tan_c * inv_R
    u_at_v = 0.25 * (so.v(u_pad) + so.v(u_pad, dx=1)
                     + so.v(u_pad, dy=-1) + so.v(u_pad, dx=1, dy=-1))
    ru_at_v = 0.25 * (so.v(rho_u_pad) + so.v(rho_u_pad, dx=1)
                      + so.v(rho_u_pad, dy=-1)
                      + so.v(rho_u_pad, dx=1, dy=-1))
    dv = -ru_at_v * u_at_v * tan_f * inv_R
    return du, dv


def slow_tendencies(model: CompressibleModel, state: CompressibleState,
                    aux: CompAux) -> SlowTendencies:
    """G^s at the stage-entry state (SlowTendencyMode: PGF+buoyancy zeroed,
    reference ``dynamics_interface.jl:387-401``), with the frozen horizontal
    ∇p^L and the vertical stage-entry imbalance −∂z(p^L−p_r) − g(ρ^L−ρ_r)
    folded in (reference ``assemble_slow_vertical_momentum_tendency!``,
    ``acoustic_substepping.jl:650-709``).

    Mode note (reference ``HorizontalSlowMode``, dynamics_interface.jl:
    408-436): because the fast loop's horizontal PGF acts on the
    perturbation p′ = p − p^L relative to THIS stage-entry state, the
    per-substep total here is ∂x p^L (slow, frozen) + ∂x p′ (fast) ≡ the
    full horizontal PGF — exactly the HorizontalSlowMode splitting.  The
    pure-SlowTendencyMode alternative (move ∂x p^L into the fast loop)
    adds the same constant to every substep and is numerically identical,
    so no mode knob is exposed; the vertical fast terms are always the
    perturbation form, avoiding the O(Δz²) hydrostatic truncation noise
    the reference's docstring warns about."""
    g = model.grid
    so = model.stencil_ops()
    ref = model.reference

    rho_u_pad = fl.pad(state.rho_u, g, fl.CCF)
    rho_v_pad = fl.pad(state.rho_v, g, fl.CFC)
    rho_w_pad = fl.pad(state.rho_w, g, fl.FCC)
    u_pad = fl.pad(aux.u, g, fl.CCF)
    v_pad = fl.pad(aux.v, g, fl.CFC)
    w_pad = fl.pad(aux.w, g, fl.FCC)

    # Here the advecting momenta are the true prognostic ρu fields.
    adv_u, adv_v, adv_w = adv.momentum_flux_divergence(
        so, model.momentum_advection,
        rho_u_pad, rho_v_pad, rho_w_pad, u_pad, v_pad, w_pad)
    cor_x, cor_y, cor_z = coriolis_terms(
        model.coriolis, so, rho_u_pad, rho_v_pad, rho_w_pad, g)

    # Mass: G_ρ^s = −∇·(ρu)^L (the stage-entry mass-flux divergence;
    # the perturbation divergence is the fast part).
    G_rho = -so.div_c(rho_u_pad, rho_v_pad, rho_w_pad)

    # ρχ: full advection scheme at stage entry (specific χ against ρ).
    # χ = θˡⁱ for the potential-temperature formulation, χ = e (moist
    # static energy) for the static-energy formulation — the prognostic
    # slot holds ρχ generically (reference ``thermodynamic_density``,
    # ``acoustic_substepping.jl:746``).
    chi = (state.rho_theta / state.rho
           if model.formulation == "static_energy" else aux.theta)
    theta_pad = fl.pad(chi, g, fl.CCC)
    rho_pad = fl.pad(state.rho, g, fl.CCC)
    G_rho_theta = -adv.div_rho_u_c(
        so, model.scalar_advection, rho_pad, u_pad, v_pad, w_pad,
        theta_pad)

    # Frozen horizontal PGF (p_r is z-only, so ∂x p^L ≡ ∂x(p^L − p_r)).
    p_pad = fl.pad(aux.p, g, fl.CCC)
    G_rho_u = -adv_u - cor_x - so.dx_cf(p_pad)
    G_rho_v = -adv_v - cor_y - so.dy_cf(p_pad)

    if g.is_latlon:
        du_m, dv_m = latlon_curvature_terms(g, so, state, u_pad, v_pad,
                                            rho_u_pad)
        G_rho_u = G_rho_u + du_m
        G_rho_v = G_rho_v + dv_m

    # Vertical: stage-entry imbalance with the same discrete face operator
    # as the reference state's balance (docs "Reference state" section).
    p_pert = aux.p - ref.p_col
    rho_pert = state.rho - jnp.broadcast_to(ref.rho_col, g.shape)
    pp_pad = fl.pad(p_pert, g, fl.CCC)
    rp_pad = fl.pad(rho_pert, g, fl.CCC)
    g_acc = model.constants.gravitational_acceleration
    imbalance = -so.dz_cf(pp_pad) - g_acc * so.iz_cf(rp_pad)
    G_rho_w = -adv_w - cor_z + imbalance

    if model.formulation == "static_energy":
        # Energy buoyancy-flux source (reference ``static_energy_tendency``
        # ``static_energy_tendency.jl:60-72``, Pauluis 2008): the ρe budget
        # D(ρe)/Dt = Dp/Dt + ρgw ≈ −w·[−∂z(p−p_r) − g(ρ−ρ_r)] — the
        # stage-entry imbalance force dotted with w (∂ₜp and the horizontal
        # u·∇p work are the slow acoustic residual, neglected as in the
        # reference's MSE budget).  Interpolated z-face → center.
        wimb_pad = fl.pad(aux.w * imbalance, g, fl.FCC)
        G_rho_theta = G_rho_theta - so.iz_fc(wimb_pad)

    G_rho_qt = (jnp.zeros_like(G_rho) if state.rho_qt is not None else None)

    nu_e = kappa_e = None
    if model.closure is not None:
        from ..physics.closures import ConstantDiffusivity, closure_tendencies

        class _AuxShim(NamedTuple):
            theta: Any
            qt: Any
            p: Any

        # True-ρ SGS weighting: stresses are −2ρνₑSᵢⱼ with the state's 3-D
        # density (reference TurbulenceClosures.jl:52-101).  The diffused
        # scalar is the formulation's χ (θˡⁱ | e — reference ∇·J on
        # ``specific_energy``, static_energy_tendency.jl:69); under ρe the
        # Smagorinsky N² proxy uses e-stratification, which matches the
        # θ-based one to O(gz/cᵖT) — documented deviation.
        cf = closure_tendencies(
            _RefShim(model), so,
            _AuxShim(theta=chi, qt=aux.qt, p=aux.p),
            u_pad, v_pad, w_pad, rho=state.rho)
        G_rho_u = G_rho_u + cf.G_u
        G_rho_v = G_rho_v + cf.G_v
        G_rho_w = G_rho_w + cf.G_w
        G_rho_theta = G_rho_theta + cf.G_theta
        if G_rho_qt is not None and cf.G_qt is not None:
            G_rho_qt = G_rho_qt + cf.G_qt
        if getattr(model.closure, "vertically_implicit", False):
            nu_e = cf.nu_e
            if cf.kappa_e is not None:
                kappa_e = cf.kappa_e
            elif isinstance(model.closure, ConstantDiffusivity):
                kappa_e = jnp.full(g.shape, model.closure.diffusivity,
                                   g.dtype)
            else:
                kappa_e = nu_e / model.closure.prandtl

    G = SlowTendencies(rho=G_rho, rho_u=G_rho_u, rho_v=G_rho_v,
                       rho_w=G_rho_w, rho_theta=G_rho_theta,
                       rho_qt=G_rho_qt, nu_e=nu_e, kappa_e=kappa_e)

    for forcing in model.forcings:
        G = forcing(model, state, aux, G) if _accepts_slow(forcing) else G
    return G


def _accepts_slow(forcing):
    return True


class _RefShim:
    """Adapter presenting a CompressibleModel with the closure interface the
    anelastic closure module expects (reference-column densities)."""

    def __init__(self, model):
        self.grid = model.grid
        self.closure = model.closure
        self.constants = model.constants
        ref = model.reference
        self.reference = _ColShim(ref)


class _ColShim:
    def __init__(self, ref):
        self.rho_col = ref.rho_col
        self.rho_f_col = ref.rho_f_col


# ---------------------------------------------------------------------------
# Acoustic substep loop
# ---------------------------------------------------------------------------

def sound_speed(model: CompressibleModel) -> float:
    c = model.constants
    td = model.time_discretization
    Rd = c.Rd
    cpd = c.dry_air.heat_capacity
    gamma = cpd / (cpd - Rd)
    return math.sqrt(gamma * Rd * td.reference_sound_temperature)


def substep_count(model: CompressibleModel, dt: float) -> int:
    """N ≈ ceil(Δt c_s / (ν Δx_min)) (docs 'practical guidance')."""
    td = model.time_discretization
    if td.substeps is not None:
        return td.substeps
    g = model.grid
    dx_min = min(g.dx, g.dy) if g.y_topology != Topology.FLAT else g.dx
    return max(1, math.ceil(dt * sound_speed(model) / (td.acoustic_cfl * dx_min)))


class StageCaches(NamedTuple):
    """Per-RK-stage linearization caches (reference ``prepare_acoustic_cache!``,
    ``acoustic_substepping.jl:283-331``).  Formulation-generic: the fields
    hold the thermodynamic variable χ (θˡⁱ or e) and the coefficients of the
    fast-system pressure linearization p′ = Cᴸ(ρχ)′ + C_ρ ρ′."""

    theta_L: jax.Array      # χ^L at centers (θ^L | e^L)
    theta_L_zf: jax.Array   # χ^L at z-faces
    C_L: jax.Array          # ∂p/∂(ρχ) at centers (γRΠ^L | Rᵐ/cᵖᵐ)
    # ∂p/∂ρ|ρχ — None for ρθ (p depends on ρθ alone); for ρe the EXACT
    # closed form p = (Rᵐ/cᵖᵐ)(ρe + (ℒq − gz)ρ) gives
    # C_ρ = (Rᵐ/cᵖᵐ)(ℒˡqˡ + ℒⁱqⁱ − gz) with q frozen over the stage.
    C_rho: jax.Array | None = None


def stage_caches(model: CompressibleModel, state: CompressibleState,
                 aux: CompAux) -> StageCaches:
    c = model.constants
    if model.has_moisture and aux.q is not None:
        Rm = c.mixture_gas_constant(aux.q)
        cpm = c.mixture_heat_capacity(aux.q)
    else:
        Rm = c.Rd
        cpm = c.dry_air.heat_capacity

    if model.formulation == "static_energy":
        # p = ρRᵐT with T = (e − gz + ℒq)/cᵖᵐ is LINEAR in (ρe, ρ) at
        # frozen q, z — the linearization is exact, and the implied fast
        # acoustic speed is the isothermal √(RᵐT) (MSE conservation under
        # compression is isothermal at fixed z; the γRT substep count of
        # :func:`sound_speed` therefore over-resolves — stable margin).
        e = state.rho_theta / state.rho
        Ce = (Rm / cpm) * jnp.ones_like(e)
        if model.has_moisture and aux.q is not None:
            lq = (c.liquid.reference_latent_heat * aux.q.liquid
                  + c.ice.reference_latent_heat * aux.q.ice)
        else:
            lq = 0.0
        C_rho = Ce * (lq - c.gravitational_acceleration
                      * model.grid.z_c_col)
        e_zf = 0.5 * (e + jnp.concatenate([e[:1], e[:-1]], axis=0))
        return StageCaches(theta_L=e, theta_L_zf=e_zf, C_L=Ce, C_rho=C_rho)

    gamma = cpm / (cpm - Rm)
    kappa = Rm / cpm
    Pi_L = (aux.p / model.p_standard) ** kappa
    C_L = gamma * Rm * Pi_L
    th = aux.theta
    th_zf = 0.5 * (th + jnp.concatenate([th[:1], th[:-1]], axis=0))
    return StageCaches(theta_L=th, theta_L_zf=th_zf, C_L=C_L)


class Perturbations(NamedTuple):
    rho: jax.Array
    rho_u: jax.Array
    rho_v: jax.Array
    rho_w: jax.Array
    rho_theta: jax.Array
    sum_rho_u: jax.Array
    sum_rho_v: jax.Array
    sum_rho_w: jax.Array


def _hpad(a, g, loc):
    """Halo-1 pad (the substep kernels are all 2nd-order stencils)."""
    return fl.pad(a, g, loc, halo=1)


def _open_boundary_relax_plan(model, state_L):
    """Per-substep open-boundary relaxation plan (reference
    ``apply_open_boundary_relaxation!``, acoustic_substepping.jl:1279-1322):
    for each axis carrying an :class:`OpenBoundaryRelaxation` forcing,
    relax ρ′/(ρθ)′ at the outermost interior cells toward the prescribed
    exterior value, target = (c_ext − c^L)/2 (→ 0 without an exterior
    state: pure perturbation damping at the open wall).

    Returns a list of (axis, α, t_rho_lo, t_rho_hi, t_rt_lo, t_rt_hi)
    with axis ∈ {1 (y), 2 (x)} and 2-D target planes.
    """
    from ..physics.forcings import OpenBoundaryRelaxation

    alpha = float(getattr(model.time_discretization,
                          "open_boundary_relaxation", 0.5))
    plan = []
    if not alpha:
        return plan
    for f in model.forcings:
        if not isinstance(f, OpenBoundaryRelaxation):
            continue
        ax = 2 if f.axis == "x" else 1
        lo = (slice(None), slice(None), 0) if ax == 2 else (slice(None), 0)
        hi = (slice(None), slice(None), -1) if ax == 2 else (slice(None), -1)

        def targets(name, field_L):
            ext = getattr(f.exterior, name, None) if f.exterior is not None \
                else None
            if ext is None:
                z = jnp.zeros_like(field_L[lo])
                return z, z
            ext = jnp.broadcast_to(ext, field_L.shape)
            return (0.5 * (ext[lo] - field_L[lo]),
                    0.5 * (ext[hi] - field_L[hi]))

        trl, trh = targets("rho", state_L.rho)
        ttl, tth = targets("rho_theta", state_L.rho_theta)
        plan.append((ax, alpha, trl, trh, ttl, tth))
    return plan


def terrain_metric_fields(terrain):
    """The eight terrain metric factors the acoustic fast loop consumes:
    ``(1/J_c, 1/J_f, J_xf, J_yf, sx_c_zf, sy_c_zf, sx_cf, sy_cf)``.

    Shard-aware wraps: under shard_map a raw jnp.roll would roll the
    LOCAL shard only (latent decomposition bug) — route through
    wrap_roll so terrain metrics exchange like every other field.
    """
    from ..parallel.halo import wrap_roll as _wroll
    invJ_c = 1.0 / terrain.jac_c3                   # (1|nz, ny, nx)
    invJ_f = 1.0 / terrain.jac_cf3                  # at ζ-faces
    sx_zf = terrain.slope_x(at_zface=True)          # (nz,·,·) at x-faces
    sy_zf = terrain.slope_y(at_zface=True)
    sx_c_zf = 0.5 * (sx_zf + _wroll(sx_zf, -1, 2))   # x-centers
    sy_c_zf = 0.5 * (sy_zf + _wroll(sy_zf, -1, 1))
    sx_cf = terrain.slope_x(at_zface=False)         # ζ-centers, x-faces
    sy_cf = terrain.slope_y(at_zface=False)
    return (invJ_c, invJ_f, terrain.jac_xf3, terrain.jac_yf3,
            sx_c_zf, sy_c_zf, sx_cf, sy_cf)


def acoustic_substep_loop(model: CompressibleModel, caches: StageCaches,
                          G: SlowTendencies, pert: Perturbations,
                          dtau, n_tau: int, gate_first: bool,
                          terrain=None, ob_relax=(),
                          rho_w_L=None) -> Perturbations:
    """Advance the linearized perturbation system n_tau substeps.

    One substep = steps A–E of reference ``acoustic_rk3_substep_loop!``
    (``acoustic_substepping.jl:1365-1551``), fused into elementwise XLA ops
    + one tridiagonal scan:
      A. forward-Euler (ρu)', (ρv)' (perturbation PGF gated on substep 0)
      B. predictors ρ'★, (ρθ)'★ from updated horizontal divergence
      C. Crank–Nicolson column solve for (ρw)'
      D. recovery of ρ', (ρθ)'; ⟨ρu⟩ accumulation
      E. Klemp horizontal divergence damping

    Terrain dispatch (``terrain_compressible_physics.jl:486-659``): with the
    Gal-Chen linear-decay map the Jacobian J is a 2-D field, so the
    σ-coordinate fast system keeps the flat loop's structure with pointwise
    reweightings — J-weighted horizontal flux divergences ×1/J, the
    contravariant vertical flux ρw̃′ = ρw′ − (sx·ℑρu′ + sy·ℑρv′) split into
    a CN-implicit ρw′ part and an explicit slope part, slope-corrected
    perturbation PGF, 1/J (gravity) and 1/J² (C·θ) scalings of the
    tridiagonal coefficients, and a kinematic-bottom Dirichlet row.
    Assumes periodic-horizontal topologies (as the explicit terrain path).
    """
    g = model.grid
    so = model.stencil_ops()
    td = model.time_discretization
    omega = td.forward_weight
    g_acc = model.constants.gravitational_acceleration
    nz = g.nz
    # Horizontal metric (spherical on lat-lon grids; scalars on Cartesian):
    # x-derivatives at y-center rows scale by 1/(R cosφ Δλ); y-flux
    # divergences are cos-weighted.
    inv_dx_c = so.inv_dx
    inv_dx_f = so.inv_dx_yface
    if g.is_latlon:
        cosf_full = g.coslat_f[None, :, None]          # (1, ny+1, 1)
        wy_lo = cosf_full[:, : g.ny]
        wy_hi = cosf_full[:, 1: g.ny + 1]
        inv_dy_c = 1.0 / (g.dy * so.cosc_row)
    else:
        wy_lo = wy_hi = 1.0
        inv_dy_c = 1.0 / g.dy
    dz_c = g.dz_c_col                      # (nz,1,1)
    dz_f = g.dz_f_col                      # faces 0..nz-1
    C_L = caches.C_L
    th_c = caches.theta_L
    th_zf = caches.theta_L_zf
    C_rho = caches.C_rho                   # ∂p/∂ρ coupling (ρe formulation)

    # Terrain metric factors (LinearDecay: 2-D → broadcast rows; SLEVE:
    # ζ-dependent J → full 3-D center/face variants; see docstring).
    if terrain is not None:
        (invJ_c, invJ_f, jac_xf3, jac_yf3, sx_c_zf, sy_c_zf,
         sx_cf, sy_cf) = terrain_metric_fields(terrain)
    else:
        invJ_c = invJ_f = 1.0

    def _shift_below(a):
        """Row k-1 of a per-ζ-center factor (duplicating the bottom row);
        passthrough for ζ-independent (broadcast or scalar) factors."""
        if isinstance(a, jax.Array) and a.shape[0] == nz:
            return jnp.concatenate([a[:1], a[:-1]], axis=0)
        return a

    invJ_c_below = _shift_below(invJ_c)   # 1/J at center k−1 (face-k row)

    # Tridiagonal coefficients (time-invariant across the stage's substeps):
    # unknown w_k = (ρw)'_new at interior faces k=1..nz-1; walls pinned 0.
    # Row k:  a w_{k-1} + b w_k + c w_{k+1} = d
    od2 = omega * omega * dtau * dtau
    # center k is ABOVE face k; center k-1 below.
    C_above = C_L                           # C at center k (for face k)
    C_below = jnp.concatenate([C_L[:1], C_L[:-1]], axis=0)    # center k-1
    thf_above = jnp.concatenate([th_zf[1:], th_zf[-1:]], axis=0)  # θf[k+1]
    thf_here = th_zf                                              # θf[k]
    thf_below = jnp.concatenate([th_zf[:1], th_zf[:-1]], axis=0)  # θf[k-1]
    dz_c_above = dz_c                                     # Δzc[k]
    dz_c_below = jnp.concatenate([dz_c[:1], dz_c[:-1]], axis=0)  # Δzc[k-1]

    # Gravity couplings carry 1/J at the ρ-update's center row; the C·θ
    # couplings carry (1/J at ζ-face k)·(1/J at the (ρθ)-update's center
    # row).  LinearDecay: all 1/J factors coincide (ζ-independent J).
    a_coef = (0.5 * g_acc * od2 / dz_c_below * invJ_c_below
              - od2 / dz_f * C_below * thf_below / dz_c_below
              * invJ_f * invJ_c_below)
    b_coef = (1.0
              - 0.5 * g_acc * od2 * (invJ_c_below / dz_c_below
                                     - invJ_c / dz_c_above)
              + od2 / dz_f * (C_above * thf_here / dz_c_above * invJ_c
                              + C_below * thf_here / dz_c_below
                              * invJ_c_below) * invJ_f)
    c_coef = (-0.5 * g_acc * od2 / dz_c_above * invJ_c
              - od2 / dz_f * C_above * thf_above / dz_c_above
              * invJ_f * invJ_c)

    # ρe formulation: the p′ = … + C_ρ ρ′ coupling adds the SAME flux
    # structure with unit face weight (the ρ predictor's flux is (ρw)′
    # itself, vs χᶠ(ρw)′ for ρχ) — C→C_ρ, χᶠ→1 term-by-term.
    if C_rho is not None:
        Cr_above = C_rho
        Cr_below = jnp.concatenate([C_rho[:1], C_rho[:-1]], axis=0)
        a_coef = a_coef - (od2 / dz_f * Cr_below / dz_c_below
                           * invJ_f * invJ_c_below)
        b_coef = b_coef + (od2 / dz_f * (Cr_above / dz_c_above * invJ_c
                                         + Cr_below / dz_c_below
                                         * invJ_c_below) * invJ_f)
        c_coef = c_coef - (od2 / dz_f * Cr_above / dz_c_above
                           * invJ_f * invJ_c)

    # Implicit upper Rayleigh sponge on (ρw)′ (reference ``UpperSponge``,
    # acoustic_substepping.jl:545-563): CN-weighted — ωΔτ·r·ramp joins the
    # diagonal, (1−ω)Δτ·r·ramp·(ρw)′ the explicit RHS below.
    sponge = getattr(td, "sponge", None)
    sponge_col = None
    sponge_full = None
    if sponge is not None:
        z_face_col = jnp.asarray(g.z_f)[: g.nz, None, None].astype(g.dtype)
        sponge_col = sponge.damping_rate * _ramp_profile(
            sponge.ramp, z_face_col, g.z0 + g.Lz, sponge.depth)
        b_coef = b_coef + omega * abs(dtau) * sponge_col
        # KDH08 full-field Rayleigh term: the layer damps the stage-entry
        # (ρw)ᴸ too, not just the substep perturbation (see UpperSponge
        # docstring) — a per-substep constant on the RHS.
        if getattr(sponge, "damp_full", False) and rho_w_L is not None:
            sponge_full = abs(dtau) * sponge_col * rho_w_L

    # Dirichlet walls: row 0 (bottom face) pinned to w = 0; the top wall
    # face nz is not stored (its coupling is dropped by the Thomas solver).
    a_coef = a_coef.at[0].set(0.0)
    c_coef = c_coef.at[0].set(0.0)
    b_coef = b_coef.at[0].set(1.0)

    def dz_fc_div(wf):
        """∂z of a z-face field → centers; top wall face (nz) is zero."""
        w_up = jnp.concatenate([wf[1:], jnp.zeros_like(wf[:1])], axis=0)
        return (w_up - wf) / dz_c

    store_dt = jnp.dtype(td.substep_floattype) if td.substep_floattype else None
    work_dt = g.dtype

    # -------- horizontal stencil machinery --------------------------------
    # Two equivalent data-movement strategies (roll == pad to roundoff,
    # pinned by ``test_roll_path_matches_pad_path``):
    #
    # - Padded stencils (DEFAULT): one halo-concat per field per substep,
    #   consumers read multiple shifted windows of the same buffer, which
    #   XLA fuses; each jnp.roll would materialize its own copy, so the
    #   roll form moves MORE data when ≥2 offsets share a field.
    # - Aligned ±1 rolls (``BREEZE_TPU_ACOUSTIC_ROLLS=1``): shard-aware
    #   wrap_roll (single-slab ppermute under shard_map) — kept for
    #   decomposition experiments where the halo-concat's full-width
    #   exchange is the bottleneck.
    #
    # Rolls require flat Cartesian periodic/FLAT horizontals; pads remain
    # the only path for terrain / lat-lon / bounded horizontals.
    from ..parallel.halo import wrap_roll as _wr
    use_rolls = (terrain is None and not g.is_latlon
                 and g.x_topology in (Topology.PERIODIC, Topology.FLAT)
                 and g.y_topology in (Topology.PERIODIC, Topology.FLAT)
                 and bool(os.environ.get("BREEZE_TPU_ACOUSTIC_ROLLS")))

    def dxf(a):                       # a[i] − a[i−1] at x-faces
        return a - _wr(a, 1, 2)

    def dyf(a):
        return a - _wr(a, 1, 1)

    def divx(F):                      # F[i+1] − F[i] at centers
        return _wr(F, -1, 2) - F

    def divy(F):
        return _wr(F, -1, 1) - F

    # θ^L face interpolants are loop-invariant — hoisted out of the substep
    # body (they were re-padded and re-interpolated every substep).
    if use_rolls:
        th_xf_h = 0.5 * (th_c + _wr(th_c, 1, 2))
        th_yf_h = 0.5 * (th_c + _wr(th_c, 1, 1))
    else:
        thp_h = _hpad(th_c, g, fl.CCC)

    def vv(a, dz=0, dy=0, dx=0):
        return a[1 + dz:1 + dz + nz, 1 + dy:1 + dy + g.ny,
                 1 + dx:1 + dx + g.nx]

    if not use_rolls:
        th_xf_h = 0.5 * (vv(thp_h) + vv(thp_h, dx=-1))
        th_yf_h = 0.5 * (vv(thp_h) + vv(thp_h, dy=-1))

    def body(i, pert):
        rho_p, ru_p, rv_p, rw_p, rt_p = (pert.rho, pert.rho_u, pert.rho_v,
                                         pert.rho_w, pert.rho_theta)
        if store_dt is not None:
            # upcast reduced-precision carries for the arithmetic
            rho_p = rho_p.astype(work_dt)
            ru_p = ru_p.astype(work_dt)
            rv_p = rv_p.astype(work_dt)
            rw_p = rw_p.astype(work_dt)
            rt_p = rt_p.astype(work_dt)

        # ---- A: horizontal momenta ----------------------------------
        p_pert = C_L * rt_p                       # p' = C^L (ρχ)' [+ C_ρ ρ']
        if C_rho is not None:
            p_pert = p_pert + C_rho * rho_p
        if use_rolls:
            dpdx = dxf(p_pert) * inv_dx_c
            dpdy = dyf(p_pert) / g.dy
        else:
            pp = _hpad(p_pert, g, fl.CCC)
            dpdx = (vv(pp) - vv(pp, dx=-1)) * inv_dx_c
            dpdy = (vv(pp) - vv(pp, dy=-1)) / g.dy
        if terrain is not None:
            # Slope-corrected perturbation PGF: (∂x p')_z = ∂x p'|_ζ − sx·∂z p'
            # with ∂z = (1/J)∂ζ (reference slope-corrected PGFs :371-448).
            dpz_f = (vv(pp) - vv(pp, dz=-1)) / dz_f * invJ_f    # ζ-faces
            dpz_c = 0.5 * (dpz_f + jnp.concatenate(
                [dpz_f[1:], dpz_f[-1:]], axis=0))               # ζ-centers
            from ..parallel.halo import wrap_roll as _wroll2
            dpdx = dpdx - sx_cf * 0.5 * (dpz_c + _wroll2(dpz_c, 1, 2))
            dpdy = dpdy - sy_cf * 0.5 * (dpz_c + _wroll2(dpz_c, 1, 1))
        apply_pgf = jnp.logical_or(i > 0, jnp.asarray(not gate_first))
        pgf_fac = jnp.where(apply_pgf, 1.0, 0.0).astype(ru_p.dtype)
        ru_new = ru_p + dtau * (G.rho_u - pgf_fac * dpdx)
        rv_new = rv_p + dtau * (G.rho_v - pgf_fac * dpdy)
        ru_new, rv_new = fl.enforce_wall_normals(g, rho_u=ru_new, rho_v=rv_new)

        # ---- B: predictors from updated horizontal divergence -------
        th_xf = th_xf_h
        th_yf = th_yf_h
        if use_rolls:
            div_h = divx(ru_new) * inv_dx_c + divy(rv_new) * inv_dy_c
            div_h_theta = (divx(th_xf * ru_new) * inv_dx_c
                           + divy(th_yf * rv_new) * inv_dy_c)
        else:
            if terrain is not None:
                rup = _hpad(jac_xf3 * ru_new, g, fl.CCF)
                rvp = _hpad(jac_yf3 * rv_new, g, fl.CFC)
            else:
                rup = _hpad(ru_new, g, fl.CCF)
                rvp = _hpad(rv_new, g, fl.CFC)
            div_h = ((vv(rup, dx=1) - vv(rup)) * inv_dx_c
                     + (wy_hi * vv(rvp, dy=1) - wy_lo * vv(rvp))
                     * inv_dy_c) * invJ_c
            # θ^L-weighted horizontal flux divergence for ρθ
            if terrain is not None:
                fx = th_xf * ru_new * jac_xf3
                fy = th_yf * rv_new * jac_yf3
            else:
                fx = th_xf * ru_new
                fy = th_yf * rv_new
            fxp = _hpad(fx, g, fl.CCF)
            fyp = _hpad(fy, g, fl.CFC)
            div_h_theta = ((vv(fxp, dx=1) - vv(fxp)) * inv_dx_c
                           + (wy_hi * vv(fyp, dy=1) - wy_lo * vv(fyp))
                           * inv_dy_c) * invJ_c

        if terrain is not None:
            # Contravariant split: ρw̃' = ρw' − S'; the S' slope part is
            # explicit (horizontal momenta already updated), ρw' is CN.
            def slope_part(ru, rv):
                rup_ = _hpad(ru, g, fl.CCF)
                rvp_ = _hpad(rv, g, fl.CFC)
                ru_czf = 0.25 * (vv(rup_) + vv(rup_, dx=1)
                                 + vv(rup_, dz=-1) + vv(rup_, dx=1, dz=-1))
                rv_czf = 0.25 * (vv(rvp_) + vv(rvp_, dy=1)
                                 + vv(rvp_, dz=-1) + vv(rvp_, dy=1, dz=-1))
                return sx_c_zf * ru_czf + sy_c_zf * rv_czf

            S_old = slope_part(ru_p, rv_p)
            S_new = slope_part(ru_new, rv_new)
            rwt_old = rw_p - S_old
            rho_star = (rho_p + dtau * (G.rho - div_h)
                        - dtau * invJ_c * ((1.0 - omega) * dz_fc_div(rwt_old)
                                         - omega * dz_fc_div(S_new)))
            rt_star = (rt_p + dtau * (G.rho_theta - div_h_theta)
                       - dtau * invJ_c * (
                           (1.0 - omega) * dz_fc_div(th_zf * rwt_old)
                           - omega * dz_fc_div(th_zf * S_new)))
        else:
            S_new = None
            rho_star = (rho_p + dtau * (G.rho - div_h)
                        - dtau * (1.0 - omega) * dz_fc_div(rw_p))
            rt_star = (rt_p + dtau * (G.rho_theta - div_h_theta)
                       - dtau * (1.0 - omega) * dz_fc_div(th_zf * rw_p))

        # ---- C: tridiagonal solve for (ρw)' -------------------------
        rho_star_zf = 0.5 * (rho_star + jnp.concatenate(
            [rho_star[:1], rho_star[:-1]], axis=0))
        rho_tau_zf = 0.5 * (rho_p + jnp.concatenate(
            [rho_p[:1], rho_p[:-1]], axis=0))
        Crt_tau = C_L * rt_p
        Crt_star = C_L * rt_star
        if C_rho is not None:
            Crt_tau = Crt_tau + C_rho * rho_p
            Crt_star = Crt_star + C_rho * rho_star
        dz_Crt_tau = (Crt_tau - jnp.concatenate(
            [Crt_tau[:1], Crt_tau[:-1]], axis=0)) / dz_f
        dz_Crt_star = (Crt_star - jnp.concatenate(
            [Crt_star[:1], Crt_star[:-1]], axis=0)) / dz_f

        d_rhs = (rw_p + dtau * G.rho_w
                 - g_acc * dtau * ((1.0 - omega) * rho_tau_zf
                                   + omega * rho_star_zf)
                 - dtau * invJ_f * ((1.0 - omega) * dz_Crt_tau
                                  + omega * dz_Crt_star))
        if sponge_col is not None:
            d_rhs = d_rhs - (1.0 - omega) * abs(dtau) * sponge_col * rw_p
        if sponge_full is not None:
            d_rhs = d_rhs - sponge_full
        if terrain is not None:
            # Kinematic bottom: ρw̃'(0) = 0 ⇒ (ρw)'(0) = S'_new(0)
            # (Dirichlet row: a=c=0, b=1 — set above).
            d_rhs = d_rhs.at[0].set(S_new[0])
        else:
            d_rhs = d_rhs.at[0].set(0.0)    # bottom wall

        rw_new = thomas_solve(a_coef, b_coef, c_coef, d_rhs)
        if terrain is None:
            rw_new = rw_new.at[0].set(0.0)

        # ---- D: recovery --------------------------------------------
        rho_new = rho_star - omega * dtau * invJ_c * dz_fc_div(rw_new)
        rt_new = rt_star - omega * dtau * invJ_c * dz_fc_div(th_zf * rw_new)

        # Per-substep open-boundary relaxation of ρ′/(ρθ)′ at the
        # outermost open cells (reference acoustic_substepping.jl:
        # 1490-1497, before the halo fill).
        for (ax, alpha, trl, trh, ttl, tth) in ob_relax:
            lo = ((slice(None), slice(None), 0) if ax == 2
                  else (slice(None), 0, slice(None)))
            hi = ((slice(None), slice(None), -1) if ax == 2
                  else (slice(None), -1, slice(None)))
            rho_new = rho_new.at[lo].add(alpha * (trl - rho_new[lo]))
            rho_new = rho_new.at[hi].add(alpha * (trh - rho_new[hi]))
            rt_new = rt_new.at[lo].add(alpha * (ttl - rt_new[lo]))
            rt_new = rt_new.at[hi].add(alpha * (tth - rt_new[hi]))

        # ---- E: horizontal divergence damping (strategy dispatch,
        # reference time_discretizations.jl:229-300) -------------------
        strategy = td.damping_strategy()
        if isinstance(strategy, ThermalDivergenceDamping) and strategy.coefficient:
            # KSH18: δτ(ρθ)/θᴸ as the divergence proxy; γ = α Δx²/Δτ.
            alpha = strategy.coefficient
            D = (rt_new - rt_p) / th_c
            # combined with 1/Δx_local the correction is
            # α Δx_local/Δτ · δx(D) (local spacing on lat-lon grids)
            fac_x = alpha * g.dx / dtau * (
                (g.coslat_c[None, :, None] if g.is_latlon else 1.0))
            gy = alpha * g.dy / dtau
            if use_rolls:
                ru_new = ru_new - fac_x * dxf(D)
                rv_new = rv_new - gy * dyf(D)
            else:
                Dp = _hpad(D, g, fl.CCC)
                ru_new = ru_new - fac_x * (vv(Dp) - vv(Dp, dx=-1))
                rv_new = rv_new - gy * (vv(Dp) - vv(Dp, dy=-1))
            ru_new, rv_new = fl.enforce_wall_normals(g, rho_u=ru_new, rho_v=rv_new)
        elif isinstance(strategy, DirectDivergenceDamping) and strategy.coefficient:
            # KSH18 eq. 36: δ = ∂ₓ(θᴸ(ρu)′) + ∂ᵧ(θᴸ(ρv)′) formed directly
            # from the updated perturbation momentum (div_h_theta above);
            # Δ(ρu)′ = α Δx² ∂ₓδ / θᴸ — no 1/Δτ (no cold-start force).
            alpha = strategy.coefficient
            fac_x = alpha * g.dx * (
                (g.coslat_c[None, :, None] if g.is_latlon else 1.0))
            if use_rolls:
                delta = (divx(th_xf * ru_new) * inv_dx_c
                         + divy(th_yf * rv_new) * inv_dy_c)
                ru_new = ru_new + fac_x * dxf(delta) / th_xf
                rv_new = rv_new + alpha * g.dy * dyf(delta) / th_yf
            else:
                # refresh δ with the post-tridiag horizontal momenta
                fx2 = _hpad(th_xf * ru_new, g, fl.CCF)
                fy2 = _hpad(th_yf * rv_new, g, fl.CFC)
                delta = ((vv(fx2, dx=1) - vv(fx2)) * inv_dx_c
                         + (wy_hi * vv(fy2, dy=1) - wy_lo * vv(fy2))
                         * inv_dy_c)
                Dp = _hpad(delta, g, fl.CCC)
                ru_new = ru_new + fac_x * (vv(Dp) - vv(Dp, dx=-1)) / th_xf
                rv_new = rv_new + alpha * g.dy * (vv(Dp) - vv(Dp, dy=-1)) / th_yf
            ru_new, rv_new = fl.enforce_wall_normals(g, rho_u=ru_new, rho_v=rv_new)

        if store_dt is not None:
            rho_new = rho_new.astype(store_dt)
            ru_new = ru_new.astype(store_dt)
            rv_new = rv_new.astype(store_dt)
            rw_new = rw_new.astype(store_dt)
            rt_new = rt_new.astype(store_dt)
        return Perturbations(
            rho=rho_new, rho_u=ru_new, rho_v=rv_new, rho_w=rw_new,
            rho_theta=rt_new,
            sum_rho_u=pert.sum_rho_u + ru_new.astype(work_dt),
            sum_rho_v=pert.sum_rho_v + rv_new.astype(work_dt),
            sum_rho_w=pert.sum_rho_w + rw_new.astype(work_dt),
        )

    if store_dt is not None:
        pert = Perturbations(
            rho=pert.rho.astype(store_dt), rho_u=pert.rho_u.astype(store_dt),
            rho_v=pert.rho_v.astype(store_dt), rho_w=pert.rho_w.astype(store_dt),
            rho_theta=pert.rho_theta.astype(store_dt),
            sum_rho_u=pert.sum_rho_u, sum_rho_v=pert.sum_rho_v,
            sum_rho_w=pert.sum_rho_w)
    out = jax.lax.fori_loop(0, n_tau, body, pert)
    if store_dt is not None:
        out = Perturbations(
            rho=out.rho.astype(work_dt), rho_u=out.rho_u.astype(work_dt),
            rho_v=out.rho_v.astype(work_dt), rho_w=out.rho_w.astype(work_dt),
            rho_theta=out.rho_theta.astype(work_dt),
            sum_rho_u=out.sum_rho_u, sum_rho_v=out.sum_rho_v,
            sum_rho_w=out.sum_rho_w)
    return out


# ---------------------------------------------------------------------------
# WS-RK3 outer loop
# ---------------------------------------------------------------------------

WS_RK3_BETAS = (1.0 / 3.0, 1.0 / 2.0, 1.0)


def stage_substep_plan(distribution: str, N: int, dt: float):
    """Per-stage ``(n_tau, dtau)`` for the WS-RK3 stages (reference
    ``AcousticSubstepDistribution``, ``time_discretizations.jl:60-117``):

    - ``proportional`` (default): Nτ = ⌈βN⌉, Δτ = βΔt/Nτ — exact coverage
      at the minimum count (Δτ may differ slightly by stage);
    - ``constant``: N rounded up to a multiple of 6, uniform Δτ = Δt/N;
    - ``monolithic_first``: stage 1 = one Δt/3 substep, stages 2-3 as
      ``constant``.
    """
    if distribution == "proportional":
        plan = []
        for beta in WS_RK3_BETAS:
            n_tau = max(1, math.ceil(beta * N - 1e-9))
            plan.append((n_tau, beta * dt / n_tau))
        return tuple(plan)
    N6 = 6 * max(1, math.ceil(N / 6))
    if distribution == "constant":
        return ((N6 // 3, dt / N6), (N6 // 2, dt / N6), (N6, dt / N6))
    if distribution == "monolithic_first":
        return ((1, dt / 3.0), (N6 // 2, dt / N6), (N6, dt / N6))
    raise ValueError(f"unknown substep_distribution {distribution!r}")


def acoustic_rk3_step(model: CompressibleModel, state: CompressibleState,
                      dt: float, substeps: int | None = None) -> CompressibleState:
    """One Δt of WS-RK3 + acoustic substepping (reference ``time_step!``,
    ``acoustic_runge_kutta_3.jl:184-232``).

    ``dt`` must be a static Python float (the substep counts are baked into
    the compiled program, as the reference does for its fixed-``substeps``
    Reactant path).
    """
    dt = float(dt)
    N = substeps if substeps is not None else substep_count(model, dt)
    g = model.grid
    td = model.time_discretization
    plan = stage_substep_plan(
        getattr(td, "substep_distribution", "proportional"), N, dt)

    # Negative-moisture repair at step start (reference
    # fix_negative_moisture!, update_atmosphere_model_state.jl:42).
    if state.rho_qt is not None:
        from ..physics.microphysics import apply_negative_moisture_correction
        with jax.named_scope("negative_moisture"):
            state = apply_negative_moisture_correction(model, state)

    if getattr(model.boundary_fluxes, "filter", None) is not None:
        from ..physics.surface import update_surface_filter
        state = update_surface_filter(
            model, state, compressible_diagnose(model, state), dt)

    state_n = state
    zero = jnp.zeros(g.shape, g.dtype)
    terrain = model.terrain

    for beta, (n_tau, dtau) in zip(WS_RK3_BETAS, plan):
        with jax.named_scope("diagnose"):
            aux_L = compressible_diagnose(model, state)
            caches = stage_caches(model, state, aux_L)
        with jax.named_scope("tendencies"):
            if terrain is not None:
                from .terrain import terrain_slow_tendencies
                G = terrain_slow_tendencies(model, terrain, state, aux_L)
            else:
                G = slow_tendencies(model, state, aux_L)
            if model.boundary_fluxes is not None:
                G = _apply_compressible_boundary_fluxes(model, state, aux_L,
                                                        G)

        # Stage rewind: perturbations start at U^n − U^L (SK08).
        pert = Perturbations(
            rho=state_n.rho - state.rho,
            rho_u=state_n.rho_u - state.rho_u,
            rho_v=state_n.rho_v - state.rho_v,
            rho_w=state_n.rho_w - state.rho_w,
            rho_theta=state_n.rho_theta - state.rho_theta,
            sum_rho_u=zero, sum_rho_v=zero, sum_rho_w=zero,
        )
        ob_relax = _open_boundary_relax_plan(model, state)
        # Stage-entry (ρw)ᴸ for the KDH08 full-field sponge (terrain:
        # the fast system carries the contravariant ρw̃′, so damp the
        # contravariant stage field).
        rho_w_L = None
        if getattr(getattr(td, "sponge", None), "damp_full", False):
            if terrain is not None:
                from .terrain import contravariant_rho_w
                so_sp = model.stencil_ops()
                rho_w_L = contravariant_rho_w(
                    terrain, so_sp, fl.pad(state.rho_u, g, fl.CCF),
                    fl.pad(state.rho_v, g, fl.CFC), state.rho_w)
            else:
                rho_w_L = state.rho_w
        with jax.named_scope("acoustic_substeps"):
            pert = acoustic_substep_loop(model, caches, G, pert, dtau,
                                         n_tau, gate_first=(n_tau > 1),
                                         terrain=terrain, ob_relax=ob_relax,
                                         rho_w_L=rho_w_L)

        # Recovery: U^(k) = U^L + perturbation (reference :1235-1257).
        if terrain is not None:
            from .terrain import kinematic_bottom_rho_w
            so = model.stencil_ops()
            new_rho_u = state.rho_u + pert.rho_u
            new_rho_v = state.rho_v + pert.rho_v
            new_rho_w = state.rho_w + pert.rho_w
            new_rho_w = new_rho_w.at[0].set(kinematic_bottom_rho_w(
                terrain, so, new_rho_u, new_rho_v))
        else:
            new_rho_u, new_rho_v, new_rho_w = fl.enforce_wall_normals(
                g, state.rho_u + pert.rho_u, state.rho_v + pert.rho_v,
                state.rho_w + pert.rho_w)
        # Time-averaged momentum for scalar transport (reference :1169-1217).
        inv_n = 1.0 / n_tau
        avg_ru = state.rho_u + pert.sum_rho_u * inv_n
        avg_rv = state.rho_v + pert.sum_rho_v * inv_n
        avg_rw = state.rho_w + pert.sum_rho_w * inv_n

        new_state = state.replace(
            rho=state.rho + pert.rho,
            rho_u=new_rho_u,
            rho_v=new_rho_v,
            rho_w=new_rho_w,
            rho_theta=state.rho_theta + pert.rho_theta,
        )

        # Scalars over βΔt with time-averaged transport velocities
        # (reference ``scalar_rk3_substep!``, acoustic_runge_kutta_3.jl:154-163).
        if state.rho_qt is not None or state.tracers:
            with jax.named_scope("scalar_transport"):
                new_state = _advance_scalars(
                    model, state_n, state, new_state, avg_ru, avg_rv,
                    avg_rw, beta * dt, G_qt_slow=G.rho_qt, terrain=terrain)

        # implicit_substep!: vertically-implicit closure diffusion over the
        # stage interval βΔt with TRUE densities (reference
        # acoustic_runge_kutta_3.jl:151); the explicit tendencies above
        # excluded the vertical diffusive fluxes (closures `vi` flag).
        if G.nu_e is not None:
            from ..physics.closures import implicit_vertical_diffusion_core

            rho_new = new_state.rho
            rho_new_f = 0.5 * (rho_new + jnp.concatenate(
                [rho_new[:1], rho_new[:-1]], axis=0))
            ru2, rv2, rt2, rq2, tr2 = implicit_vertical_diffusion_core(
                g, rho_new, rho_new_f, G.nu_e, G.kappa_e, beta * dt,
                new_state.rho_u, new_state.rho_v, new_state.rho_theta,
                new_state.rho_qt, new_state.tracers)
            new_state = new_state.replace(
                rho_u=ru2, rho_v=rv2, rho_theta=rt2, rho_qt=rq2, tracers=tr2)

        state = new_state

    # Operator-split microphysics once per step (mirrors the anelastic
    # stepper; reference ``microphysics_model_update!`` after stage 3).
    if model.microphysics is not None and hasattr(model.microphysics, "model_update"):
        state = model.microphysics.model_update(model, state, dt)

    return state.replace(time=state.time + dt)


def _advance_scalars(model, state_n, state_L, new_state, avg_ru, avg_rv,
                     avg_rw, beta_dt, G_qt_slow=None, terrain=None):
    g = model.grid
    so = model.stencil_ops()
    rho_pad = fl.pad(state_L.rho, g, fl.CCC)
    rho_safe = jnp.maximum(state_L.rho, 1e-30)
    if terrain is not None:
        # σ-form scalar transport: J-weighted horizontal + contravariant
        # vertical mass fluxes, divergence ×1/J (as the explicit terrain
        # path; reference terrain scalar transport dispatch).
        from .terrain import contravariant_rho_w
        avg_rwt = contravariant_rho_w(
            terrain, so, fl.pad(avg_ru, g, fl.CCF),
            fl.pad(avg_rv, g, fl.CFC), avg_rw)
        avg_rwt = avg_rwt.at[0].set(0.0)
        jac_xf3 = terrain.jac_xf[None]
        jac_yf3 = terrain.jac_yf[None]
        invJ = 1.0 / terrain.jac_c3
        u_pad = fl.pad(jac_xf3 * avg_ru / rho_safe, g, fl.CCF)
        v_pad = fl.pad(jac_yf3 * avg_rv / rho_safe, g, fl.CFC)
        w_pad = fl.pad(avg_rwt / rho_safe, g, fl.FCC)
    else:
        invJ = 1.0
        # transport velocities from time-averaged momentum against stage density
        u_pad = fl.pad(avg_ru / rho_safe, g, fl.CCF)
        v_pad = fl.pad(avg_rv / rho_safe, g, fl.CFC)
        w_pad = fl.pad(avg_rw / rho_safe, g, fl.FCC)

    def G_scalar(rho_c_field):
        c_pad = fl.pad(rho_c_field / state_L.rho, g, fl.CCC)
        return -adv.div_rho_u_c(so, model.scalar_advection, rho_pad,
                                u_pad, v_pad, w_pad, c_pad) * invJ

    updates = {}
    if state_L.rho_qt is not None:
        Gq = G_scalar(state_L.rho_qt)
        if G_qt_slow is not None:
            Gq = Gq + G_qt_slow
        updates["rho_qt"] = state_n.rho_qt + beta_dt * Gq
    tr = {}
    for name, val in state_L.tracers.items():
        tr[name] = state_n.tracers[name] + beta_dt * G_scalar(val)
    if tr:
        updates["tracers"] = tr
    return new_state.replace(**updates)


def _apply_compressible_boundary_fluxes(model, state, aux, G):
    """Surface fluxes (prescribed or bulk) as bottom-cell tendencies against
    the TRUE surface-layer density (reference ``compute_flux_bc_tendencies!``
    on the compressible model, ``update_atmosphere_model_state.jl:418-434``)."""
    from ..physics.surface import surface_flux_values

    bf = model.boundary_fluxes
    g = model.grid
    dz0 = g.dz_c[0]
    if model.terrain is not None:
        dz0 = dz0 * model.terrain.jac_c   # true bottom-cell thickness JΔζ
    rho0 = state.rho[0]

    th_flux, qt_flux, F_u, F_v = surface_flux_values(
        bf, model, state, aux, want_moisture=G.rho_qt is not None)

    out = {}
    if th_flux is not None:
        if model.formulation == "static_energy":
            # Sensible-heat conversion of the kinematic θ flux into an
            # e flux: F_e = cᵖᵈ Π₀ F_θ (Π₀ = T_r/θ_r at the surface level).
            c = model.constants
            ref = model.reference
            Pi0 = ref.T_col[0] / ref.theta_col[0]
            th_flux = c.dry_air.heat_capacity * Pi0 * th_flux
        out["rho_theta"] = G.rho_theta.at[0].add(rho0 * th_flux / dz0)
    if qt_flux is not None and G.rho_qt is not None:
        out["rho_qt"] = G.rho_qt.at[0].add(rho0 * qt_flux / dz0)
    if F_u is not None:
        out["rho_u"] = G.rho_u.at[0].add(rho0 * F_u / dz0)
        out["rho_v"] = G.rho_v.at[0].add(rho0 * F_v / dz0)
    return G._replace(**out)


# ---------------------------------------------------------------------------
# Fully explicit path (validation; reference ExplicitTimeStepping)
# ---------------------------------------------------------------------------

def explicit_tendencies(model: CompressibleModel, state: CompressibleState):
    """Full tendencies incl. PGF + buoyancy (perturbation form), for the
    SSP-RK3 explicit compressible path (small Δt, validates EOS/tendencies
    before split-explicit — SURVEY.md §7 phase 6)."""
    aux = compressible_diagnose(model, state)
    G = slow_tendencies(model, state, aux)  # already has frozen PGF + imbalance
    return G, aux


def explicit_rk3_step(model: CompressibleModel, state: CompressibleState,
                      dt) -> CompressibleState:
    """SSP-RK3 fully explicit compressible step (3-D acoustic CFL limited).

    Note: here the 'slow' tendencies are the complete right-hand side —
    the frozen PGF/buoyancy terms are exact at each stage state.
    """
    if state.rho_qt is not None:
        from ..physics.microphysics import apply_negative_moisture_correction
        state = apply_negative_moisture_correction(model, state)

    if getattr(model.boundary_fluxes, "filter", None) is not None:
        from ..physics.surface import update_surface_filter
        state = update_surface_filter(
            model, state, compressible_diagnose(model, state), dt)

    g = model.grid
    so = model.stencil_ops()
    alphas = (1.0, 0.25, 2.0 / 3.0)
    s0 = state
    for alpha in alphas:
        G, aux = explicit_tendencies(model, state)
        new = {}
        for name in ("rho", "rho_u", "rho_v", "rho_w", "rho_theta"):
            u0 = getattr(s0, name)
            u = getattr(state, name)
            Gn = getattr(G, name)
            new[name] = (1 - alpha) * u0 + alpha * (u + dt * Gn)
        new["rho_w"] = fl.enforce_impenetrability(new["rho_w"], model.grid)

        if state.rho_qt is not None or state.tracers:
            rho_pad = fl.pad(state.rho, g, fl.CCC)
            u_pad = fl.pad(aux.u, g, fl.CCF)
            v_pad = fl.pad(aux.v, g, fl.CFC)
            w_pad = fl.pad(aux.w, g, fl.FCC)
            if state.rho_qt is not None:
                q_pad = fl.pad(state.rho_qt / state.rho, g, fl.CCC)
                Gq = -adv.div_rho_u_c(so, model.scalar_advection, rho_pad,
                                      u_pad, v_pad, w_pad, q_pad)
                if G.rho_qt is not None:
                    Gq = Gq + G.rho_qt
                new["rho_qt"] = ((1 - alpha) * s0.rho_qt
                                 + alpha * (state.rho_qt + dt * Gq))
            tr = {}
            for name, val in state.tracers.items():
                c_pad = fl.pad(val / state.rho, g, fl.CCC)
                Gc = -adv.div_rho_u_c(so, model.scalar_advection, rho_pad,
                                      u_pad, v_pad, w_pad, c_pad)
                tr[name] = ((1 - alpha) * s0.tracers[name]
                            + alpha * (val + dt * Gc))
            if tr:
                new["tracers"] = tr
        state = state.replace(**new)

    if model.microphysics is not None and hasattr(model.microphysics, "model_update"):
        state = model.microphysics.model_update(model, state, dt)

    return state.replace(time=state.time + dt)
