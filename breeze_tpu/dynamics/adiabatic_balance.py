"""Adiabatic (FV3 ``na_init``) initialization: spin up a balanced ρw.

Equivalent of reference
``src/AtmosphereModels/adiabatic_balance.jl:44-281``
(``balance_adiabatically!`` + ``AdiabaticBalancer`` + the stripped
memory-sharing twin).  Analyses (ERA5/GFS) cold-start w at zero; each cycle
runs two symmetric forward/backward excursions at ±Δt, letting ρw develop,
then nudges every OTHER prognostic back toward its t = 0 snapshot

    x ← (x + weight·x₀) / (1 + weight)

(ρw is never nudged — the balance the excursion imprints is what is kept).

Functional redesign: no in-place twin sharing field memory — the "twin" is
just ``dataclasses.replace`` on the immutable model config (microphysics →
passive vapor, closure/forcings/surface fluxes stripped, AIVA unwrapped,
compressible time discretization → fully explicit), and the balanced
``state`` is returned.  The whole spin-up jits into one XLA program.
"""

from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp

from .. import advection as adv

#: Conservative fraction of the vertical acoustic CFL for the auto Δt
#: (reference ``adiabatic_balance.jl: acoustic_cfl_safety``).
ACOUSTIC_CFL_SAFETY = 0.85


@dataclasses.dataclass(frozen=True)
class PassiveVapor:
    """Moisture carried as passive, non-condensing vapor.

    Twin microphysics for the adiabatic excursion (reference
    ``assemble_adiabatic_twin``: ``twin_microphysics = nothing`` with the
    moisture slot re-mapped to ρqᵛ): ``diagnose`` takes the vapor-only
    branch, so the excursion is pure, reversible dynamics."""


def _unwrap_aiva(scheme):
    if isinstance(scheme, adv.AdaptiveImplicitVerticalAdvection):
        return scheme.scheme       # the implicit remainder is irreversible
    return scheme


def adiabatic_twin(model):
    """Stripped, reversible twin of ``model`` (anelastic or compressible).

    Removes everything dissipative or irreversible (reference
    ``assemble_adiabatic_twin``): microphysics (moisture → passive vapor),
    closure (and with it the vertically-implicit diffusion solve), forcings
    (incl. sponges), surface fluxes, AIVA implicit splits; a compressible
    twin additionally swaps the split-explicit discretization (divergence
    damping, in-loop sponge — irreversible) for fully-explicit stepping,
    the reference's ``DefaultTimeStepping`` choice.
    """
    kw = dict(
        microphysics=PassiveVapor() if model.microphysics is not None else None,
        closure=None,
        forcings=(),
        boundary_fluxes=None,
        momentum_advection=_unwrap_aiva(model.momentum_advection),
        scalar_advection=_unwrap_aiva(model.scalar_advection),
    )
    from .compressible import CompressibleModel, ExplicitTimeStepping
    if isinstance(model, CompressibleModel):
        kw["time_discretization"] = ExplicitTimeStepping()
    return dataclasses.replace(model, **kw)


def resolve_balance_dt(model, state=None) -> float:
    """Auto Δt: ``0.85 · Δz_min / c`` with c from the warmest analysis
    temperature (reference ``resolve_balance_Δt``)."""
    c = model.constants
    Rd = c.Rd
    cp = c.dry_air.heat_capacity
    gamma = cp / (cp - Rd)
    T_star = _max_temperature(model, state) if state is not None else 320.0
    cs = math.sqrt(gamma * Rd * T_star)
    return ACOUSTIC_CFL_SAFETY * model.grid.dz_min / cs


def _max_temperature(model, state):
    from .compressible import CompressibleModel, compressible_diagnose
    if isinstance(model, CompressibleModel):
        return float(jnp.max(compressible_diagnose(model, state).T))
    from ..model import diagnose
    return float(jnp.max(diagnose(model, state).T))


def _step_fn(twin):
    from .compressible import CompressibleModel, explicit_rk3_step
    if isinstance(twin, CompressibleModel):
        return explicit_rk3_step
    from ..timesteppers import ssp_rk3_step
    return ssp_rk3_step


_NUDGED = ("rho", "rho_u", "rho_v", "rho_theta", "rho_qt")  # never rho_w


def _snapshot(state):
    snap = {k: getattr(state, k, None) for k in _NUDGED}
    snap["tracers"] = dict(state.tracers)
    return snap


def _nudge(state, snap, weight):
    """x ← (x + w·x₀)/(1 + w) for every prognostic except ρw
    (reference ``nudge_initial_fields!``)."""
    inv = 1.0 / (1.0 + weight)
    kw = {}
    for k in _NUDGED:
        x = getattr(state, k, None)
        if x is not None and snap.get(k) is not None:
            kw[k] = (x + weight * snap[k]) * inv
    kw["tracers"] = {k: (v + weight * snap["tracers"][k]) * inv
                     for k, v in state.tracers.items()}
    return state.replace(**kw)


def balance_adiabatically(model, state, *, dt=None, cycles: int = 1,
                          weight: float = 2.0, with_moisture: bool = True):
    """Spin ρw (and the nonhydrostatic pressure balance) into balance with
    the analysis fields; returns the balanced state at the original time.

    Reference ``balance_adiabatically!(model; Δt, cycles, weight)`` +
    the ``AdiabaticBalancer`` entry point (``adiabatic_balance.jl:44-281``).
    ``with_moisture=False`` restores ρqᵗ exactly afterwards (the reference's
    moisture-preserving graft mode).  Works for both the anelastic
    ``AtmosphereModel`` and the ``CompressibleModel``.
    """
    twin = adiabatic_twin(model)
    step = _step_fn(twin)
    if dt is None:
        dt = resolve_balance_dt(model, state)
    dt = float(dt)

    rho_qt0 = state.rho_qt
    time0 = state.time
    snap = _snapshot(state)

    for _ in range(cycles):
        # Half-cycle A: 0 → +Δt → 0, nudge.
        state = step(twin, state, +dt)
        state = step(twin, state, -dt)
        state = _nudge(state, snap, weight)
        # Half-cycle B: 0 → −Δt → 0, nudge.
        state = step(twin, state, -dt)
        state = step(twin, state, +dt)
        state = _nudge(state, snap, weight)

    if not with_moisture and rho_qt0 is not None:
        state = state.replace(rho_qt=rho_qt0)
    return state.replace(time=time0)
